"""Hopper kernels for the class-group hot loops (counterpart of
cofhe_tpu/ops/pallas_group.py).

Thirteen kernels, CUDA C++ for sm_90a under cofhe_tpu_torch/csrc/, built with
nvcc into plain-C shared libraries at first use and bound with ctypes. Each
gives one warp to one batch row (K5m up to four at small batches); the
source notes say more.

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
  plain version is ops/compose2_plain.py::grouped_rho_loop_wide, whose
  limbs it matches. Held back by the scalar simulation between groups,
  which the design keeps to products, comparisons and one or two
  divisions a step.
* KT `reduce_exact` (csrc/reduce_exact.cu) replaces the XLA while loop of
  forms.py::reduce_batch, the exact tail after K3: canonicalizes K3's
  redundant rows and takes each lane to its unique reduced form by rho
  steps and translations with the kernel's own quotients (up to 40 bits
  a step, from float64 estimates), several rows' canonicalizations and
  compares side by side. Its plain version is
  `reduce_exact_plain` (canonicalize, then ops/forms.py::reduce_batch);
  reduced forms are unique, so the two agree bit for bit although their
  step sequences differ.

* K5m `mag_mul` (csrc/mag_mul.cu) replaces the XLA product of
  limb.py::_poly_mul8 / mag_mul: a * b mod 2^(16 L_out), its 8-bit limb
  products on the tensor cores (Toeplitz tiles through integer mma.sync,
  m16n8k32 u8); its plain version is limb.mag_mul_plain (a float64 FFT).
* K5d `divexact_odd` (csrc/divexact_odd.cu) replaces the XLA Hensel scan
  of limb.py::mag_divexact_odd: x * y^-1 mod 2^(16 L_out) for odd y, LSB
  first from its own 16-bit inverse; its plain version is
  limb.mag_divexact_odd_plain (a 2-adic Newton inverse and a product).
* K4 `redc_mod` (csrc/redc_mod.cu) replaces the XLA loop of
  rl.py::redc_pow16 with the port's final subtraction (forms2.CG.
  _redc_mod): x * 2^(-16 steps) mod d in [0, d) for odd d, limb by limb
  from its own 16-bit inverse; its plain version is rl.redc_mod.

* K7 `lehmer_euclid` (csrc/lehmer_euclid.cu) replaces the XLA while loop
  of rl.py::lehmer_euclid, the opt-in NUCOMP tail's Lehmer walk: grouped
  continued-fraction steps on f32 top-word estimates summed in XLA-CPU's
  order (three rows side by side), their quotients from f32 reciprocals
  with no integer division, a 2^13 matrix applied to six redundant rows,
  a warp a block, each lane leaving on its own and a second pass giving
  the stopped lanes the batch loop's carry passes; its plain version is
  rl.lehmer_euclid, whose limbs, `par` and working groups it matches.

* K6a `canon_sm` (csrc/canon_sm.cu) replaces limb.py::canonicalize_fast
  where compose2 (and its NUCOMP tail) applies it to a short signed sum
  (sm_add / sm_sub, 2 m2, sq + |Delta|/4): sum(k * sign * mag) of up to
  three terms to (sign, canonical mag), with mag >> shr cut to W_shr
  limbs on request, one or two sums a launch; its plain version is
  `canon_sm_plain` (the sum in torch ops, then limb.canonicalize_fast).
* K6b `compose_prologue` (csrc/compose_prologue.cu) replaces compose2's
  prologue up to s and dd (the identity masks and substitution, the
  swap, rotate_to_odd, s and dd) and, where the narrow width Lxn is below
  L, the first gcd's operands, in one launch; its plain version is
  compose2_plain.compose2_prologue_plain.
* K6c `gcd_bridge` (csrc/gcd_bridge.cu) replaces the selects between
  compose2's two gcds: d1 and beta merged from the first gcd's two
  passes, fits8, rare and the second gcd's divisors; its plain version is
  compose2_plain.gcd_bridge_plain.
* K6d `gcd2_merge` (csrc/gcd2_merge.cu) replaces the merge of the second
  gcd's two pipelines into g and eta0; its plain version is
  compose2_plain.gcd2_merge_plain.
* K6e `c3_operands` (csrc/c3_operands.cu) replaces mag_v2 and the two
  dynamic shifts before c3's exact quotient; its plain version is
  compose2_plain.c3_operands_plain.

The main path runs 97% of K2's and K3's launches at 128-256 lanes, where a
kernel's time is the latency of one warp's loop rather than the card's
rate; the kernels the main path runs have four warps a block (K7, off
the main path, one). The earlier plain versions,
rl.mod_topdown and forms2.grouped_rho_loop, stay as references.

Each kernel has a dispatcher, a module-level function that ops/forms2.py
(and limb.mag_mul / mag_divexact_odd) call, built from one table,
`DISPATCH`: by kernel name, the dispatcher's name, the kernel's label and
the argument whose tensor picks the route. A CPU tensor goes to the plain
version, `<dispatcher>_plain` (`plain_route`), any other to the CUDA
wrapper, `<dispatcher>_cuda`, which launches the kernel on a CUDA tensor
and raises on anything else; there is no fallback from the kernel to the
plain version. Both are read from the module at each call, so a test or
a tool may replace either. Each `*_cuda`
wrapper adds one to `LAUNCHES[name]` and to `LAUNCHES_BY_KEY[(name,
width, extra, batch)]` (extra: nbits or Lm, the operand widths "LaxLb" of
a product or "LxxLy" of a quotient, d's width for a REDC, the group cap
of a Lehmer walk, the term widths of a K6a sum (`canon_sm_key`), Lh (and
Lxn) for the prologue, Lxn and Lh for the gcd bridge, the width-8 rows'
width for the merge, a3's width for c3's operands, else 0) where it
launches its kernel and nowhere else.
While a thread captures a CUDA graph (`capturing_launches`, ops/graphs.py) its
launches are recorded into the graph's key list instead, and the graph's
`GraphLaunches` (`graph_launches`) counts its replays: the kernels run
once a replay. A replay only bumps that count; `LAUNCHES` and
`LAUNCHES_BY_KEY` add each graph's keys times its replays when they are
read, and fold a freed graph's into the eager counts.

Rows of up to NARROW_LIMBS = 288 limbs (9 a thread) fit every kernel.
K2, K5m, K6a and K6e (`WIDE_KERNELS`) have a second compiled instance of
the same code at 10 limbs a thread, for rows of 289 to MAX_LIMBS = 320
limbs (compose2 at sec=128, k=128 runs none; at k=256 its Lm is 296 and
|Delta| / 4 has 320 limbs). The row width alone chooses the instance
(`wide_key`); `WIDE_LAUNCHES` counts the wide instances' launches by
kernel, read like `LAUNCHES`. K5d reads only the quotient's limbs of its
rows, so it takes dividends and divisors of up to MAX_LIMBS limbs (c3's at
k=256: (296, 296) -> 160) with quotients of up to NARROW_LIMBS.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from collections.abc import Callable, Mapping
from typing import NamedTuple

import torch

from . import limb as lb
from . import compose2_plain, rl, xgcd2
from .forms import BForm, reduce_batch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cofhe_tpu_torch")
NARROW_LIMBS = 288  # 9 limbs per thread x 32 threads: every kernel
MAX_LIMBS = 320  # 10 limbs per thread: the wide instances of WIDE_KERNELS
WIDE_KERNELS = ("mod_topdown", "mag_mul", "canon_sm", "c3_operands")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C entry points: device pointers, ints (and a double), then the stream
_ARGTYPES = {
    "xgcd_coeff_g": [_P] * 7 + [_I] * 4 + [_P],
    "mod_topdown": [_P] * 4 + [_I] * 4 + [_P],
    "reduce2_grouped": [_P] * 7 + [_I] * 4 + [_D, _P],
    "reduce_exact": [_P] * 8 + [_I] * 3 + [_P],
    "mag_mul": [_P] * 3 + [_I] * 6 + [_P],
    "divexact_odd": [_P] * 3 + [_I] * 6 + [_P],
    "redc_mod": [_P] * 4 + [_I] * 6 + [_P],
    "lehmer_euclid": [_P] * 13 + [_I] * 4 + [_P],
    # host arrays of device pointers and of ints, then ints
    "canon_sm": [_P, _P] + [_I] * 5 + [_P],
    "compose_prologue": [_P, _P] + [_I] * 4 + [_P],
    "gcd_bridge": [_P, _P] + [_I] * 4 + [_P],
    "gcd2_merge": [_P, _P] + [_I] * 3 + [_P],
    "c3_operands": [_P] * 4 + [_I] * 3 + [_P],
}
KERNELS = tuple(_ARGTYPES)


class Dispatch(NamedTuple):
    """A kernel's dispatcher: its module-level `name`, beside which
    `<name>_plain` and `<name>_cuda` stand; the kernel's `label`; and
    `route(args)`, the tensor among the call's positional arguments whose
    device picks the route."""

    name: str
    label: str
    route: Callable


def _arg0(args):
    return args[0]


# every kernel's dispatcher, by kernel name (the keys of _ARGTYPES)
DISPATCH = {
    "xgcd_coeff_g": Dispatch("xgcd_coeff_g", "K1", _arg0),
    "mod_topdown": Dispatch("mod_topdown", "K2", _arg0),
    "reduce2_grouped": Dispatch("reduce2_grouped_loop", "K3", _arg0),
    "reduce_exact": Dispatch("reduce_exact", "KT", _arg0),
    "mag_mul": Dispatch("mag_mul", "K5m", _arg0),
    "divexact_odd": Dispatch("mag_divexact_odd", "K5d", _arg0),
    "redc_mod": Dispatch("redc_mod", "K4", _arg0),
    "lehmer_euclid": Dispatch("lehmer_euclid", "K7", _arg0),
    # the first term's magnitude
    "canon_sm": Dispatch("canon_sm", "K6a", lambda args: args[0][0][0]),
    # F1.a
    "compose_prologue": Dispatch("compose_prologue", "K6b", lambda args: args[0].a),
    "gcd_bridge": Dispatch("gcd_bridge", "K6c", _arg0),
    "gcd2_merge": Dispatch("gcd2_merge", "K6d", _arg0),
    "c3_operands": Dispatch("c3_operands", "K6e", _arg0),
}

# launches outside graphs (and of freed graphs), by (kernel, width, extra,
# batch)
_EAGER: dict = {}
# the GraphLaunches of the captured graphs not yet folded into _EAGER
_GRAPHS: set = set()
_GRAPHS_LOCK = threading.Lock()
# the key list of the graph this thread is capturing, if any
_CAPTURE = threading.local()

_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_INFO: dict = {"seconds": None, "log": ""}


class GraphLaunches:
    """The launches a captured graph makes each replay (`per_replay`: key
    -> count) and its replays; `base` is its replays at the last
    `reset_launches`, `owner` a weak reference to the graph."""

    __slots__ = ("per_replay", "replays", "base", "owner")

    def __init__(self, owner, keys):
        self.per_replay: dict = {}
        for key in keys:
            self.per_replay[key] = self.per_replay.get(key, 0) + 1
        self.replays = 0
        self.base = 0
        self.owner = weakref.ref(owner)


def graph_launches(owner, keys) -> GraphLaunches:
    """The launch record of `owner`, a graph that replays `keys`: counted in
    LAUNCHES from now on; the owner adds one to `replays` a replay."""
    g = GraphLaunches(owner, keys)
    with _GRAPHS_LOCK:
        _GRAPHS.add(g)
    return g


def _add_replays(by_key: dict, g: GraphLaunches) -> None:
    n = g.replays - g.base
    if n:
        for key, c in g.per_replay.items():
            by_key[key] = by_key.get(key, 0) + c * n


def wide_key(key: tuple) -> bool:
    """Whether launch key (name, width, extra, batch) ran a wide instance
    (rows past NARROW_LIMBS): K2 by x's width, K5m by the output's, K6a
    by the sum's, K6e by the wider of a3 (extra) and csum."""
    name, width = key[0], key[1]
    if name == "c3_operands":
        width = max(width, key[2])
    return name in WIDE_KERNELS and width > NARROW_LIMBS


class _Launches(Mapping):
    """Launches so far, read-only: by kernel name (every kernel, 0 where
    none ran; with `wide`, the five kernels that have a wide instance and
    only the launches of it) or by key. The eager launches counted as they
    run, plus each graph's launches a replay times its replays since the
    last reset, added when read; a freed graph's are folded into the eager
    counts."""

    def __init__(self, by_name: bool, wide: bool = False):
        self._by_name, self._wide = by_name, wide

    def _read(self) -> dict:
        with _GRAPHS_LOCK:
            for g in [g for g in _GRAPHS if g.owner() is None]:
                _GRAPHS.discard(g)
                _add_replays(_EAGER, g)
            by_key = dict(_EAGER)
            for g in _GRAPHS:
                _add_replays(by_key, g)
        if not self._by_name:
            return by_key
        by_name = dict.fromkeys(WIDE_KERNELS if self._wide else KERNELS, 0)
        for key, c in by_key.items():
            if not self._wide or wide_key(key):
                by_name[key[0]] += c
        return by_name

    def __getitem__(self, key):
        return self._read()[key]

    def __iter__(self):
        return iter(self._read())

    def __len__(self) -> int:
        return len(self._read())


LAUNCHES = _Launches(by_name=True)
# launches by (kernel, width, extra, batch)
LAUNCHES_BY_KEY = _Launches(by_name=False)
# launches of the wide instances, by kernel name (WIDE_KERNELS)
WIDE_LAUNCHES = _Launches(by_name=True, wide=True)


def reset_launches() -> None:
    with _GRAPHS_LOCK:
        _EAGER.clear()
        for g in _GRAPHS:
            g.base = g.replays


def count_launches(keys) -> None:
    """Count one eager launch for each (name, width, extra, batch) key."""
    for key in keys:
        _EAGER[key] = _EAGER.get(key, 0) + 1


@contextlib.contextmanager
def capturing_launches(keys: list):
    """Inside, this thread's launches are appended to `keys` (the graph
    being captured: the kernels are recorded, not run) and not counted."""
    prev = getattr(_CAPTURE, "keys", None)
    _CAPTURE.keys = keys
    try:
        yield keys
    finally:
        _CAPTURE.keys = prev


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


def _rows(name: str, t: torch.Tensor, ref: torch.Tensor | None = None):
    """(rows, row stride): t's limbs as (rows, W) int32 on one CUDA device
    with unit limb stride (a copy only where the view has none)."""
    if t.device.type != "cuda" or (ref is not None and t.device != ref.device):
        raise ValueError(f"{name}: every tensor must be on one CUDA device, "
                         f"got {t.device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name}: int32 limbs required, got {t.dtype}")
    x = t.reshape(-1, t.shape[-1])
    if x.shape[1] > 1 and x.stride(1) != 1:
        x = x.contiguous()
    return x, x.stride(0)


def _broadcast(name: str, u: torch.Tensor, v: torch.Tensor):
    """u and v with their leading dimensions broadcast against each other,
    as the plain versions' products broadcast them, and that shape."""
    try:
        lead = torch.broadcast_shapes(u.shape[:-1], v.shape[:-1])
    except RuntimeError as e:
        raise ValueError(f"{name}: leading shapes {tuple(u.shape[:-1])} and "
                         f"{tuple(v.shape[:-1])} do not broadcast") from e
    return u.expand(*lead, u.shape[-1]), v.expand(*lead, v.shape[-1]), lead


def plain_route(t: torch.Tensor) -> bool:
    """Whether the dispatchers send `t` to the plain versions: a CPU tensor
    does; a CUDA tensor goes to the kernels, and the wrappers refuse any
    other device."""
    return t.device.type == "cpu"


def _launch(key: tuple, ref: torch.Tensor, *args) -> None:
    """Launch kernel key[0] on the current stream of ref's device; count it
    under `key` = (name, width, extra, batch), or record it in the graph
    this thread is capturing."""
    name = key[0]
    fn = build()[name]
    with torch.cuda.device(ref.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} at {key}")
    keys = getattr(_CAPTURE, "keys", None)
    if keys is not None:
        keys.append(key)
    else:
        count_launches((key,))


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
    if not 1 <= W <= NARROW_LIMBS:
        raise ValueError(f"xgcd_coeff_g: width {W} outside [1, {NARROW_LIMBS}]")
    d = torch.empty_like(f_mag)
    cg = torch.empty_like(f_mag)
    cu = torch.empty_like(f_mag) if need_u else None
    groups = xgcd2.groups_for_bits(nbits)
    _launch(("xgcd_coeff_g", W, int(nbits), B), f_mag, f_mag.data_ptr(),
            g_mag.data_ptr(), m_mag.data_ptr(), d.data_ptr(), cg.data_ptr(),
            cu.data_ptr() if need_u else None, _iters_ptr(iters, B, f_mag),
            B, W, groups, int(need_u))
    return (d, cg, cu) if need_u else (d, cg)


# ----------------------------------------------------------- K2: mod_topdown


def mod_topdown_plain(x, m_mag, max_iters: int, iters=None):
    return rl.mod_topdown28(x, m_mag, max_iters=max_iters, iters=iters)


def mod_topdown_cuda(x, m_mag, max_iters: int, iters=None):
    """K2 on the card: same contract and output as rl.mod_topdown28 (and
    rl.mod_topdown). `iters`, if given, receives each row's number of loop
    iterations."""
    B, L = x.shape[0], x.shape[-1]
    Lm = m_mag.shape[-1]
    if m_mag.shape[0] != B:
        raise ValueError("mod_topdown: x and m must share the batch size")
    full = NARROW_LIMBS if L <= NARROW_LIMBS else MAX_LIMBS  # the row's class
    if not 1 <= Lm < L <= MAX_LIMBS or Lm > full - 3:
        raise ValueError(f"mod_topdown: need 1 <= Lm < Lx <= {MAX_LIMBS} and "
                         f"Lm <= {full - 3}, got Lm={Lm}, Lx={L}")
    _check("mod_topdown", x, m_mag)
    out = torch.empty_like(x)
    _launch(("mod_topdown", L, Lm, B), x, x.data_ptr(), m_mag.data_ptr(),
            out.data_ptr(), _iters_ptr(iters, B, x), B, L, Lm, int(max_iters))
    return out


# ------------------------------------------------- K3: grouped rho-descent


reduce2_grouped_loop_plain = compose2_plain.grouped_rho_loop_wide


def reduce2_grouped_loop_cuda(a, b, c, dD_mant: float, dD_top: int,
                              red_iters: int, iters=None):
    """K3 on the card: compose2_plain.grouped_rho_loop_wide on redundant
    (a, b, c); returns the same redundant limbs, whose exact tail is the
    unique reduced form. `iters`, if given, receives each row's number of
    groups."""
    _check("reduce2_grouped", a, b, c)
    B, L = a.shape
    if b.shape != (B, L) or c.shape != (B, L):
        raise ValueError("reduce2_grouped: a, b and c must share one shape")
    if not 1 <= L <= NARROW_LIMBS:
        raise ValueError(f"reduce2_grouped: width {L} outside [1, {NARROW_LIMBS}]")
    ao, bo, co = torch.empty_like(a), torch.empty_like(b), torch.empty_like(c)
    _launch(("reduce2_grouped", L, 0, B), a, a.data_ptr(), b.data_ptr(),
            c.data_ptr(), ao.data_ptr(), bo.data_ptr(), co.data_ptr(),
            _iters_ptr(iters, B, a), B, L, int(dD_top), int(red_iters),
            float(dD_mant))
    return ao, bo, co


# ------------------------------------------------------ KT: the exact tail


def reduce_exact_plain(a, b, c, max_iters: int) -> BForm:
    """Canonicalize redundant (a, b, c) (a, c positive, b signed) and
    reduce them exactly with forms.reduce_batch (at most max_iters masked
    iterations, one host test each)."""
    _, am = lb.canonicalize_fast(a)
    sb, bm = lb.canonicalize_fast(b)
    _, cm = lb.canonicalize_fast(c)
    return reduce_batch(BForm(am, sb, bm, cm), max_iters)


def reduce_exact_cuda(a, b, c, max_iters: int, iters=None) -> BForm:
    """KT on the card: the unique reduced form of each row of redundant
    (a, b, c), as a canonical BForm of the inputs' width, as
    reduce_exact_plain gives it. `iters`, if given, receives each row's
    number of steps (max_iters + 1 for a row still unreduced at the cap,
    which only this output reports: reading it would be a host sync)."""
    _check("reduce_exact", a, b, c)
    B, L = a.shape
    if b.shape != (B, L) or c.shape != (B, L):
        raise ValueError("reduce_exact: a, b and c must share one shape")
    if not 1 <= L <= NARROW_LIMBS:
        raise ValueError(f"reduce_exact: width {L} outside [1, {NARROW_LIMBS}]")
    ao, bo, co = torch.empty_like(a), torch.empty_like(b), torch.empty_like(c)
    bs = torch.empty(B, dtype=torch.int32, device=a.device)
    _launch(("reduce_exact", L, 0, B), a, a.data_ptr(), b.data_ptr(),
            c.data_ptr(), ao.data_ptr(), bs.data_ptr(), bo.data_ptr(),
            co.data_ptr(), _iters_ptr(iters, B, a), B, L, int(max_iters))
    return BForm(ao, bs, bo, co)


# ------------------------------------------------------------ K5m: products

mag_mul_plain = lb.mag_mul_plain


def mag_mul_cuda(ma, mb, L_out: int | None = None):
    """K5m on the card: limb.mag_mul_plain's product, (..., L_out)
    canonical (mod 2^(16 L_out)), of canonical (..., La) and (..., Lb)
    limbs whose leading shapes broadcast (each limb read as its low 16
    bits, as the plain version reads it)."""
    La, Lb = ma.shape[-1], mb.shape[-1]
    if L_out is None:
        L_out = La + Lb
    ma, mb, lead = _broadcast("mag_mul", ma, mb)
    if not 1 <= L_out <= MAX_LIMBS or max(La, Lb) > MAX_LIMBS:
        raise ValueError(f"mag_mul: widths La={La}, Lb={Lb}, L_out={L_out} "
                         f"outside [1, {MAX_LIMBS}]")
    a, sa = _rows("mag_mul", ma)
    b, sb = _rows("mag_mul", mb, a)
    B = a.shape[0]
    out = torch.empty((B, L_out), dtype=torch.int32, device=a.device)
    _launch(("mag_mul", L_out, f"{La}x{Lb}", B), a, a.data_ptr(), b.data_ptr(),
            out.data_ptr(), B, La, Lb, sa, sb, L_out)
    return out.reshape(*lead, L_out)


# ------------------------------------------------ K5d: exact quotients


mag_divexact_odd_plain = lb.mag_divexact_odd_plain


def mag_divexact_odd_cuda(x, y, L_out: int, inv=None):
    """K5d on the card: x * y^-1 mod 2^(16 L_out) for odd y (L_out <= x's
    width; leading shapes broadcast), as limb.mag_divexact_odd_plain gives
    it; the kernel takes its own 16-bit inverse of y, so `inv`, the plain
    version's, is ignored."""
    Lx, Ly = x.shape[-1], y.shape[-1]
    x, y, lead = _broadcast("mag_divexact_odd", x, y)
    if L_out > Lx:
        raise ValueError(f"L_out {L_out} exceeds the dividend width {Lx}")
    if not 1 <= L_out <= NARROW_LIMBS or max(Lx, Ly) > MAX_LIMBS or Ly < 1:
        raise ValueError(f"mag_divexact_odd: widths Lx={Lx}, Ly={Ly} outside "
                         f"[1, {MAX_LIMBS}] or L_out={L_out} outside "
                         f"[1, {NARROW_LIMBS}]")
    xr, sx = _rows("mag_divexact_odd", x)
    yr, sy = _rows("mag_divexact_odd", y, xr)
    B = xr.shape[0]
    q = torch.empty((B, L_out), dtype=torch.int32, device=xr.device)
    _launch(("divexact_odd", L_out, f"{Lx}x{Ly}", B), xr, xr.data_ptr(),
            yr.data_ptr(), q.data_ptr(), B, Lx, Ly, sx, sy, L_out)
    return q.reshape(*lead, L_out)


# ------------------------------------------------------- K4: Montgomery REDC


redc_mod_plain = rl.redc_mod


def redc_mod_cuda(x, d_mag, steps: int, active=None, inv=None):
    """K4 on the card: rl.redc_mod's x * 2^(-16 steps) mod d in [0, d) at
    x's width, for canonical (B, Lx) x and odd (B, Ld) d, Ld <= Lx; rows
    outside the (B,) bool `active` get floor(x / 2^(16 steps)) reduced
    once by d. The kernel takes its own 16-bit inverse of d, so `inv`,
    the plain version's, is ignored."""
    if x.dim() != 2 or d_mag.dim() != 2 or d_mag.shape[0] != x.shape[0]:
        raise ValueError(f"redc_mod: (B, Lx) x and (B, Ld) d required, got "
                         f"{tuple(x.shape)} and {tuple(d_mag.shape)}")
    Lx, Ld = x.shape[1], d_mag.shape[1]
    if not 1 <= Ld <= Lx or steps < 0 or max(Lx, steps + Ld) + 1 > NARROW_LIMBS:
        raise ValueError(f"redc_mod: need 1 <= Ld <= Lx and max(Lx, steps + Ld) "
                         f"< {NARROW_LIMBS}, got Lx={Lx}, Ld={Ld}, steps={steps}")
    xr, sx = _rows("redc_mod", x)
    dr, sd = _rows("redc_mod", d_mag, xr)
    B = xr.shape[0]
    act = None
    if active is not None:
        if active.shape != (B,) or active.dtype != torch.bool \
                or active.device != xr.device:
            raise ValueError("redc_mod: active must be a (B,) bool tensor on "
                             "the inputs' device")
        act = active.contiguous()
    out = torch.empty((B, Lx), dtype=torch.int32, device=xr.device)
    _launch(("redc_mod", Lx, Ld, B), xr, xr.data_ptr(), dr.data_ptr(),
            None if act is None else act.data_ptr(), out.data_ptr(), B, Lx, Ld,
            sx, sd, int(steps))
    return out


# ------------------------------------------------------- K7: the Lehmer walk


lehmer_euclid_plain = rl.lehmer_euclid


def lehmer_euclid_cuda(r0_mag, r1_mag, bits_stop, max_groups: int,
                       sim_steps: int = 8, active=None, iters=None):
    """K7 on the card: rl.lehmer_euclid's (rp, rc, xp, xc, yp, yc, par) of
    (B, L) magnitudes r0, r1, with bits_stop a (B,) f32 tensor and
    `active` an optional (B,) bool tensor. `iters`, if given, receives
    each lane's number of working groups."""
    r0_mag, r1_mag = r0_mag.contiguous(), r1_mag.contiguous()
    _check("lehmer_euclid", r0_mag, r1_mag)
    B, L = r0_mag.shape
    dev = r0_mag.device
    if r1_mag.shape != (B, L):
        raise ValueError("lehmer_euclid: r0 and r1 must share one (B, L) shape")
    if not 1 <= L <= NARROW_LIMBS:
        raise ValueError(f"lehmer_euclid: width {L} outside [1, {NARROW_LIMBS}]")
    if bits_stop.shape != (B,) or bits_stop.dtype != torch.float32 \
            or bits_stop.device != dev:
        raise ValueError("lehmer_euclid: bits_stop must be a (B,) float32 "
                         "tensor on the inputs' device")
    bits_stop = bits_stop.contiguous()
    act = None
    if active is not None:
        if active.shape != (B,) or active.dtype != torch.bool or active.device != dev:
            raise ValueError("lehmer_euclid: active must be a (B,) bool tensor "
                             "on the inputs' device")
        act = active.contiguous()
    rows = [torch.empty_like(r0_mag) for _ in range(6)]
    par = torch.empty(B, dtype=torch.int32, device=dev)
    work = torch.empty(B + 2, dtype=torch.int32, device=dev)
    _launch(("lehmer_euclid", L, int(max_groups), B), r0_mag, r0_mag.data_ptr(),
            r1_mag.data_ptr(), bits_stop.data_ptr(),
            None if act is None else act.data_ptr(),
            *(r.data_ptr() for r in rows), par.data_ptr(),
            _iters_ptr(iters, B, r0_mag), work.data_ptr(), B, L,
            int(max_groups), int(sim_steps))
    return (*rows, par)


# ------------------------------------------------ K6a: signed sums, canonical


def canon_sm_plain(terms, W: int, shr: int = 0, W_shr: int | None = None,
                   terms2=None):
    """limb.canonicalize_fast of sum(k * sign * resize(mag, W)) over the
    terms (mag, sign or None for 1, k): limb.sm_add / sm_sub of two signed
    magnitudes, and with one term the canonicalization of a redundant row.
    Returns (sign, mag), with W_shr also resize(mag >> shr, W_shr); with
    `terms2`, a second sum's result beside the first's."""
    def one(ts):
        acc = None
        for mag, sign, k in ts:
            t = lb.resize(mag, W)
            if sign is not None:
                t = sign[..., None] * t
            if k != 1:
                t = k * t
            acc = t if acc is None else acc + t
        sg, mag = lb.canonicalize_fast(acc)
        if W_shr is None:
            return sg, mag
        return sg, mag, lb.resize(lb.mag_shr_bits(mag, shr), W_shr)

    return one(terms) if terms2 is None else (one(terms), one(terms2))


def _canon_row(terms, W: int, B: int, ref, keep: list):
    """The C entry point's pointers and ints of one sum's terms."""
    if not 1 <= len(terms) <= 3:
        raise ValueError(f"canon_sm: 1-3 terms a sum, got {len(terms)}")
    ptrs, ints = [], []
    for mag, sign, k in terms:
        m, stride = _rows("canon_sm", mag, ref)
        if mag.dim() != 2 or m.shape[0] not in (1, B):
            raise ValueError(f"canon_sm: (B, L) or (1, L) terms required, got "
                             f"{tuple(mag.shape)} at batch {B}")
        if m.shape[0] == 1:
            stride = 0
        sp = None
        if sign is not None:
            if sign.shape != (B,) or sign.dtype != torch.int32 \
                    or sign.device != ref.device:
                raise ValueError("canon_sm: a sign must be a (B,) int32 tensor "
                                 "on the terms' device")
            sign = sign.contiguous()
            sp = sign.data_ptr()
        keep += [m, sign]
        ptrs += [m.data_ptr(), sp]
        ints += [m.shape[1], int(k), stride]
    ptrs += [None, None] * (3 - len(terms))
    ints += [0, 0, 0] * (3 - len(terms))
    return ptrs, ints


def canon_sm_key(terms, W: int, shr: int = 0, W_shr: int | None = None,
                 terms2=None) -> tuple:
    """K6a's launch key (name, W, extra, B): extra gives each sum's term
    widths ("72+144", two sums "a,b") and the shifted output (">>1:136")."""
    rows = [terms] if terms2 is None else [terms, terms2]
    extra = ",".join("+".join(str(t[0].shape[-1]) for t in ts) for ts in rows)
    if W_shr is not None:
        extra += f">>{shr}:{W_shr}"
    return ("canon_sm", W, extra, max(t[0].shape[0] for ts in rows for t in ts))


def canon_sm_cuda(terms, W: int, shr: int = 0, W_shr: int | None = None,
                  terms2=None):
    """K6a on the card: canon_sm_plain's outputs, one launch for one sum or
    two (`terms2`). Terms are (mag, sign, k): mag a (B, L) or (1, L) int32
    row (read at min(L, W) limbs, zero-extended), sign a (B,) int32 tensor
    or None, k an int."""
    rows = [terms] if terms2 is None else [terms, terms2]
    key = canon_sm_key(terms, W, shr, W_shr, terms2)
    ref, B = terms[0][0], key[3]
    if not 1 <= W <= MAX_LIMBS or not 0 <= shr < 16 \
            or (W_shr is not None and not 1 <= W_shr <= W):
        raise ValueError(f"canon_sm: need 1 <= W <= {MAX_LIMBS}, 0 <= shr < 16 "
                         f"and 1 <= W_shr <= W, got W={W}, shr={shr}, W_shr={W_shr}")
    keep: list = []
    ptrs, ints, outs = [], [], []
    for ts in rows:
        p, n = _canon_row(ts, W, B, ref, keep)
        sg = torch.empty(B, dtype=torch.int32, device=ref.device)
        mag = torch.empty((B, W), dtype=torch.int32, device=ref.device)
        half = None if W_shr is None else torch.empty(
            (B, W_shr), dtype=torch.int32, device=ref.device)
        ptrs += p + [sg.data_ptr(), mag.data_ptr(),
                     None if half is None else half.data_ptr()]
        ints += n
        outs.append((sg, mag) if half is None else (sg, mag, half))
    _launch(key, ref, (ctypes.c_void_p * len(ptrs))(*ptrs),
            (ctypes.c_longlong * len(ints))(*ints), len(rows), B, W, int(shr),
            0 if W_shr is None else W_shr)
    return outs[0] if terms2 is None else tuple(outs)


# -------------------------------------------------- K6b: compose2's prologue


compose_prologue_plain = compose2_plain.compose2_prologue_plain


def _bool_rows(name: str, B: int, dev, *masks) -> None:
    for m in masks:
        if m.shape != (B,) or m.dtype != torch.bool or m.device != dev \
                or not m.is_contiguous():
            raise ValueError(f"{name}: masks must be contiguous (B,) bool tensors on "
                             "the rows' device")


def compose_prologue_cuda(F1: BForm, F2: BForm, h: BForm, h2: BForm, Lh: int,
                          Lxn: int | None = None):
    """K6b on the card: compose_prologue_plain's (a1, b1s, b1m, c1, a2,
    b2s, b2m, c2, ss, sm, dds, ddm, id1, id2) of canonical (B, L) forms F1,
    F2 and the substitute forms h, h2 (one row each), and with a narrow
    width Lxn < L the first gcd's (fx, a2_n, a1_n, a2_w, a1_w) after
    them."""
    B, L = F1.a.shape[0], F1.a.shape[-1]
    dev = F1.a.device
    ins = []
    for F in (F1, F2):
        if F.a.dim() != 2 or F.a.shape != (B, L) or F.b.shape != (B, L) \
                or F.c.shape != (B, L) or F.b_sign.shape != (B,):
            raise ValueError("compose_prologue: F1 and F2 must be (B, L) forms of "
                             "one shape")
        ins += [x.contiguous() for x in F]
    for F in (h, h2):
        if any(x.numel() != L for x in (F.a, F.b, F.c)) or F.b_sign.numel() != 1:
            raise ValueError("compose_prologue: h and h2 must be single forms "
                             f"of {L} limbs")
        ins += [x.contiguous() for x in F]
    if not 1 <= Lh <= L <= NARROW_LIMBS or B * L >= 1 << 31:
        raise ValueError(f"compose_prologue: need 1 <= Lh <= L <= {NARROW_LIMBS} and "
                         f"B L < 2^31, got B={B}, L={L}, Lh={Lh}")
    if any(x.device != dev or x.dtype != torch.int32 for x in ins) or dev.type != "cuda":
        raise ValueError("compose_prologue: int32 tensors on one CUDA device required")
    narrow = Lxn is not None and Lxn < L
    if narrow and Lxn < 2:
        raise ValueError(f"compose_prologue: the narrow width Lxn must be >= 2, got {Lxn}")

    def rows(n):
        return torch.empty((B, n), dtype=torch.int32, device=dev)

    def signs():
        return torch.empty(B, dtype=torch.int32, device=dev)

    def masks():
        return torch.empty(B, dtype=torch.bool, device=dev)

    outs = (rows(L), signs(), rows(L), rows(L), rows(L), signs(), rows(L), rows(L),
            signs(), rows(Lh), signs(), rows(Lh), masks(), masks())
    if narrow:
        outs += (masks(), rows(Lxn), rows(Lxn), rows(L), rows(L))
    _launch(("compose_prologue", L, f"{Lh},Lxn={Lxn}" if narrow else Lh, B), F1.a,
            (ctypes.c_void_p * 16)(*(x.data_ptr() for x in ins)),
            (ctypes.c_void_p * len(outs))(*(x.data_ptr() for x in outs)), B, L, Lh,
            Lxn if narrow else 0)
    return outs


# ------------------------------------- K6c: from the first gcd to the second


gcd_bridge_plain = compose2_plain.gcd_bridge_plain


def gcd_bridge_cuda(d1_w, beta_w, id1, id2, Lh: int, narrow=None):
    """K6c on the card: gcd_bridge_plain's (d1, beta, fits8, rare, d1_8,
    d1_8 at Lh, d1h) of the full-width pass's canonical (B, L) d1_w,
    beta_w, the (B,) bool identity masks and, with `narrow` = (d1_n,
    beta_n, fx), the narrow pass's (B, Lxn) rows and its (B,) bool mask.
    Without it, d1 and beta are d1_w and beta_w themselves."""
    _check("gcd_bridge", d1_w, beta_w)
    B, L = d1_w.shape
    dev = d1_w.device
    if beta_w.shape != (B, L):
        raise ValueError("gcd_bridge: d1_w and beta_w must share one (B, L) shape")
    if not 8 <= Lh <= L <= NARROW_LIMBS:
        raise ValueError(f"gcd_bridge: need 8 <= Lh <= L <= {NARROW_LIMBS}, got L={L}, Lh={Lh}")
    _bool_rows("gcd_bridge", B, dev, id1, id2)
    ins = [d1_w, beta_w, id1, id2]
    Lxn = 0
    if narrow is not None:
        d1_n, beta_n, fx = narrow
        _check("gcd_bridge", d1_w, d1_n, beta_n)
        Lxn = d1_n.shape[1]
        if d1_n.shape != (B, Lxn) or beta_n.shape != (B, Lxn) or Lxn > L:
            raise ValueError("gcd_bridge: d1_n and beta_n must share one (B, Lxn) shape, "
                             "Lxn <= L")
        _bool_rows("gcd_bridge", B, dev, fx)
        ins += [d1_n, beta_n, fx]

    def rows(n):
        return torch.empty((B, n), dtype=torch.int32, device=dev)

    outs = [rows(L), rows(L)] if narrow is not None else [None, None]
    outs += [torch.empty(B, dtype=torch.bool, device=dev),
             torch.empty(B, dtype=torch.bool, device=dev), rows(8), rows(Lh), rows(Lh)]
    ptrs = [None if x is None else x.data_ptr() for x in ins + [None] * (7 - len(ins))]
    _launch(("gcd_bridge", L, f"Lxn={Lxn},Lh={Lh}", B), d1_w, (ctypes.c_void_p * 7)(*ptrs),
            (ctypes.c_void_p * 7)(*(None if x is None else x.data_ptr() for x in outs)),
            B, L, Lxn, Lh)
    if narrow is None:
        outs[:2] = [d1_w, beta_w]
    return tuple(outs)


# ----------------------------------- K6d: the second gcd's pipelines merged


gcd2_merge_plain = compose2_plain.gcd2_merge_plain


def gcd2_merge_cuda(g8, eta0_8, gF, eta0F, fits8):
    """K6d on the card: gcd2_merge_plain's (g, eta0) at Lh limbs of the
    width-8 pipeline's (B, W8) g8, eta0_8, the rare pipeline's (B, Lh) gF,
    eta0F and the (B,) bool fits8, W8 <= Lh."""
    _check("gcd2_merge", g8, eta0_8, gF, eta0F)
    B, W8 = g8.shape
    Lh = gF.shape[1]
    if eta0_8.shape != (B, W8) or gF.shape != (B, Lh) or eta0F.shape != (B, Lh) \
            or not 1 <= W8 <= Lh <= NARROW_LIMBS:
        raise ValueError("gcd2_merge: (B, W8) g8, eta0_8 and (B, Lh) gF, eta0F "
                         f"required, 1 <= W8 <= Lh <= {NARROW_LIMBS}")
    _bool_rows("gcd2_merge", B, g8.device, fits8)
    g, eta0 = torch.empty_like(gF), torch.empty_like(eta0F)
    ins = (g8, eta0_8, gF, eta0F, fits8)
    _launch(("gcd2_merge", Lh, W8, B), g8, (ctypes.c_void_p * 5)(*(x.data_ptr() for x in ins)),
            (ctypes.c_void_p * 2)(g.data_ptr(), eta0.data_ptr()), B, W8, Lh)
    return g, eta0


# --------------------------------------------------- K6e: c3's operands


c3_operands_plain = compose2_plain.c3_operands_plain


def c3_operands_cuda(a3, csum):
    """K6e on the card: c3_operands_plain's (csum >> min(e, 16 Lm - 1),
    a3 >> e at Lm limbs), e = v2(a3), of canonical (B, L) a3 and (B, Lm)
    csum."""
    B, L = a3.shape[0], a3.shape[-1]
    Lm = csum.shape[-1]
    if csum.shape[0] != B or not 1 <= L <= MAX_LIMBS or not 1 <= Lm <= MAX_LIMBS:
        raise ValueError(f"c3_operands: (B, L) a3 and (B, Lm) csum required, L and Lm "
                         f"in [1, {MAX_LIMBS}]")
    _check("c3_operands", a3, csum)
    csum_sh, a3_odd = torch.empty_like(csum), torch.empty_like(csum)
    _launch(("c3_operands", Lm, L, B), a3, a3.data_ptr(), csum.data_ptr(),
            csum_sh.data_ptr(), a3_odd.data_ptr(), B, L, Lm)
    return csum_sh, a3_odd


# ---------------------------------------------------------- the dispatchers


def _dispatcher(kernel: str, d: Dispatch):
    mod = globals()

    def dispatch(*args, **kwargs):
        side = "_plain" if plain_route(d.route(args)) else "_cuda"
        return mod[d.name + side](*args, **kwargs)

    dispatch.__name__ = dispatch.__qualname__ = d.name
    dispatch.__doc__ = (f"Dispatcher of {d.label} `{kernel}`: {d.name}_plain for CPU "
                        f"tensors, {d.name}_cuda (the kernel) for CUDA tensors.")
    return dispatch


globals().update({d.name: _dispatcher(k, d) for k, d in DISPATCH.items()})
