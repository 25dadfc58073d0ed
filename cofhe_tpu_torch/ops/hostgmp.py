"""GMP-backed host engine (ctypes over csrc/classgroup.cpp).

The port's copy of the JAX package's host backend: class-group
compose/nudupl/nupow in C++ on GMP with OpenMP across batch elements (the
reference's BICYCL + OpenMP cost model, include/x86_64/qfi.inl:1-135,
openmp.hpp:4-11). Used (a) as `device="host"` behind the port's
CryptoSystem facade, (b) by the element-level exponentiations of
core.cl_hsm2k (pk = h^sk, h^r, pk^r) and (c) as the bit-exact host check in
chip_smoke.py.

The library is compiled with g++ from the repository's csrc/classgroup.cpp
into build/cofhe_tpu_torch/ (content-hashed name) at first use. When g++ or
libgmp is missing, `get_lib()` returns None and callers fall back to the
pure-Python oracle (core.qfi).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ..core.qfi import Form

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "csrc", "classgroup.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "cofhe_tpu_torch")


def get_lib():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        # freshness is keyed on a content hash of the source embedded in the
        # artifact name (mtimes are arbitrary after checkout)
        if not os.path.exists(_SRC):
            return None
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:12]
        out = os.path.join(BUILD_DIR, f"libcofhe_classgroup-{tag}.so")
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = out + f".tmp{os.getpid()}"
            try:
                subprocess.run(
                    ["g++", "-O3", "-fopenmp", "-shared", "-fPIC", "-o",
                     tmp, _SRC, "-l:libgmp.so.10"],
                    check=True, capture_output=True, timeout=180)
                os.replace(tmp, out)  # atomic vs concurrent builds
            except (OSError, subprocess.SubprocessError):
                return None
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
        try:
            lib = ctypes.CDLL(out)
        except OSError:
            return None
        c = ctypes.c_void_p
        i64 = ctypes.c_int64
        lib.cg_num_threads.restype = ctypes.c_int
        lib.cg_compose_batch.restype = None
        lib.cg_compose_batch.argtypes = [c, c, c, c, c, c, i64, i64, c, i64]
        lib.cg_nudupl_batch.restype = None
        lib.cg_nudupl_batch.argtypes = [c, c, c, c, i64, i64, c, i64]
        lib.cg_nupow_batch.restype = None
        lib.cg_nupow_batch.argtypes = [c, c, c, c, i64, c, c, i64, i64, c, i64]
        lib.cg_nupow_shared_batch.restype = None
        lib.cg_nupow_shared_batch.argtypes = [c, c, c, c, i64, i64, c, c,
                                              i64, i64, c, i64]
        _LIB = lib
        return _LIB


class GmpClassGroup:
    """Batched class-group ops for one discriminant D < 0."""

    def __init__(self, D: int):
        self.lib = get_lib()
        if self.lib is None:
            raise RuntimeError("native classgroup backend unavailable")
        self.D = D
        absD = -D
        self._disc = np.frombuffer(
            absD.to_bytes((absD.bit_length() + 7) // 8, "little"),
            dtype=np.uint8).copy()
        # reduced coords are <= sqrt(|D|/3); full |D| width + slack is safe
        # for normalized intermediates too (compose/nudupl reduce internally)
        self.stride = (absD.bit_length() + 7) // 8 + 8

    def _pack(self, forms) -> tuple[np.ndarray, np.ndarray]:
        n = len(forms)
        st = self.stride
        buf = np.zeros((n, 3, st), dtype=np.uint8)
        signs = np.ones((n, 3), dtype=np.int8)
        for i, f in enumerate(forms):
            for j, v in enumerate((f.a, f.b, f.c)):
                if v < 0:
                    signs[i, j] = -1
                    v = -v
                b = v.to_bytes((v.bit_length() + 7) // 8 or 1, "little")
                buf[i, j, :len(b)] = np.frombuffer(b, dtype=np.uint8)
        return buf, signs

    def _unpack(self, buf: np.ndarray, signs: np.ndarray) -> list[Form]:
        out = []
        for i in range(buf.shape[0]):
            vals = []
            for j in range(3):
                v = int.from_bytes(buf[i, j].tobytes(), "little")
                vals.append(-v if signs[i, j] < 0 else v)
            out.append(Form(*vals))
        return out

    def compose_batch(self, forms1, forms2) -> list[Form]:
        n = len(forms1)
        b1, s1 = self._pack(forms1)
        b2, s2 = self._pack(forms2)
        ob = np.zeros_like(b1)
        os_ = np.ones_like(s1)
        self.lib.cg_compose_batch(
            b1.ctypes.data, s1.ctypes.data, b2.ctypes.data, s2.ctypes.data,
            ob.ctypes.data, os_.ctypes.data, n, self.stride,
            self._disc.ctypes.data, len(self._disc))
        return self._unpack(ob, os_)

    def nudupl_batch(self, forms) -> list[Form]:
        n = len(forms)
        b, s = self._pack(forms)
        ob = np.zeros_like(b)
        os_ = np.ones_like(s)
        self.lib.cg_nudupl_batch(
            b.ctypes.data, s.ctypes.data, ob.ctypes.data, os_.ctypes.data,
            n, self.stride, self._disc.ctypes.data, len(self._disc))
        return self._unpack(ob, os_)

    def nupow_batch(self, forms, exps) -> list[Form]:
        n = len(forms)
        b, s = self._pack(forms)
        elen = max(1, max((abs(int(e)).bit_length() for e in exps), default=1))
        elen = (elen + 7) // 8
        eb = np.zeros((n, elen), dtype=np.uint8)
        es = np.ones(n, dtype=np.int8)
        for i, e in enumerate(exps):
            e = int(e)
            if e < 0:
                es[i] = -1
                e = -e
            bb = e.to_bytes(elen, "little")
            eb[i] = np.frombuffer(bb, dtype=np.uint8)
        ob = np.zeros_like(b)
        os_ = np.ones_like(s)
        self.lib.cg_nupow_batch(
            b.ctypes.data, s.ctypes.data, eb.ctypes.data, es.ctypes.data,
            elen, ob.ctypes.data, os_.ctypes.data, n, self.stride,
            self._disc.ctypes.data, len(self._disc))
        return self._unpack(ob, os_)


    def nupow_shared_batch(self, forms, exps_per_form) -> list[Form]:
        """forms[i] ^ e for each e in exps_per_form[i] (len-p rows), the
        doubling chain shared per form (reference qfi.inl:28-62 cache)."""
        n = len(forms)
        p = len(exps_per_form[0]) if n else 0
        b, s = self._pack(forms)
        flat = [int(e) for row in exps_per_form for e in row]
        elen = max(1, max((abs(e).bit_length() for e in flat), default=1))
        elen = (elen + 7) // 8
        eb = np.zeros((n * p, elen), dtype=np.uint8)
        es = np.ones(n * p, dtype=np.int8)
        for i, e in enumerate(flat):
            if e < 0:
                es[i] = -1
                e = -e
            eb[i] = np.frombuffer(e.to_bytes(elen, "little"), dtype=np.uint8)
        ob = np.zeros((n * p, 3, self.stride), dtype=np.uint8)
        os_ = np.ones((n * p, 3), dtype=np.int8)
        self.lib.cg_nupow_shared_batch(
            b.ctypes.data, s.ctypes.data, eb.ctypes.data, es.ctypes.data,
            elen, p, ob.ctypes.data, os_.ctypes.data, n, self.stride,
            self._disc.ctypes.data, len(self._disc))
        return self._unpack(ob, os_)


class GmpEngine:
    """Same batched-op surface as ops.engine.JaxEngine, on the GMP backend.

    Parallelism model = the reference's: OpenMP static-schedule loops over
    tensor elements (cpu_cryptosystem_vector_ops.inl:13,95)."""

    def __init__(self, hsm2k):
        self.hsm = hsm2k
        self.cg = GmpClassGroup(hsm2k.Delta)

    def compose_forms_batch(self, forms1, forms2):
        return self.cg.compose_batch(forms1, forms2)

    def add_batch(self, cts1, cts2):
        from ..core.cl_hsm2k import CipherText

        n = len(cts1)
        f1 = [ct.c1 for ct in cts1] + [ct.c2 for ct in cts1]
        f2 = [ct.c1 for ct in cts2] + [ct.c2 for ct in cts2]
        out = self.cg.compose_batch(f1, f2)
        return [CipherText(out[i], out[n + i]) for i in range(n)]

    def scal_batch(self, scalars, cts):
        from ..core.cl_hsm2k import CipherText

        n = len(cts)
        forms = [ct.c1 for ct in cts] + [ct.c2 for ct in cts]
        exps = list(scalars) + list(scalars)
        out = self.cg.nupow_batch(forms, exps)
        return [CipherText(out[i], out[n + i]) for i in range(n)]

    def part_decrypt_batch(self, share: int, cts):
        return self.cg.nupow_batch([ct.c1 for ct in cts],
                                   [share] * len(cts))

    def decrypt_batch(self, sk: int, cts):
        from ..core.qfi import neg as qneg, reduce_form

        c1sk = self.part_decrypt_batch(sk, cts)
        inv = [reduce_form(qneg(f)) for f in c1sk]
        fm = self.cg.compose_batch([ct.c2 for ct in cts], inv)
        return [self.hsm.dlog_in_F(f) for f in fm]

    def scal_matmul(self, s_tensor, ct_tensor, zero_ct):
        """ct (n,m) x s (m,p) -> (n,p): batched pow then a batched
        log-depth composition tree over m, then + Enc(0)."""
        from ..core.cl_hsm2k import CipherText
        from ..tensor import Tensor

        n, m = ct_tensor.shape
        _, p = s_tensor.shape
        cells = [ct_tensor.at(i, j) for i in range(n) for j in range(m)]
        s = [int(s_tensor.at(j, k)) for j in range(m) for k in range(p)]
        # rows: (h, i, j, k) h in {c1, c2}; doubling chain shared across the
        # p exponents of each cell (reference qfi.inl:28-62)
        forms = []
        rows = []
        for half in range(2):
            for i in range(n):
                for j in range(m):
                    ct = cells[i * m + j]
                    forms.append(ct.c1 if half == 0 else ct.c2)
                    rows.append(s[j * p:(j + 1) * p])
        powed = self.cg.nupow_shared_batch(forms, rows)
        # tree-reduce over j: state (2, n, m_cur, p)
        cur = powed
        m_cur = m
        while m_cur > 1:
            half_m = m_cur // 2
            A, B, keep = [], [], []
            for h in range(2):
                for i in range(n):
                    base = (h * n + i) * m_cur * p
                    for j in range(half_m):
                        for k in range(p):
                            A.append(cur[base + (2 * j) * p + k])
                            B.append(cur[base + (2 * j + 1) * p + k])
                    if m_cur % 2:
                        for k in range(p):
                            keep.append(cur[base + (m_cur - 1) * p + k])
            comp = self.cg.compose_batch(A, B)
            nxt = []
            ki = 0
            ci = 0
            m_next = half_m + (m_cur % 2)
            for h in range(2):
                for i in range(n):
                    nxt.extend(comp[ci:ci + half_m * p])
                    ci += half_m * p
                    if m_cur % 2:
                        nxt.extend(keep[ki:ki + p])
                        ki += p
            cur = nxt
            m_cur = m_next
        z1 = [zero_ct.c1] * (n * p)
        z2 = [zero_ct.c2] * (n * p)
        fin = self.cg.compose_batch(cur, z1 + z2)
        cts = [CipherText(fin[i], fin[n * p + i]) for i in range(n * p)]
        return Tensor(cts, (n, p))
