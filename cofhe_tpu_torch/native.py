"""Native wire-format codec (csrc/codec.cpp): build on first use + ctypes
bindings (the port's copy of cofhe_tpu/native.py).

The codec packs and unpacks bignum tensors between the reference-compatible
byte format and int32 limb arrays without Python bigint churn. It is host
code, not a device kernel. The library is compiled with g++ from the
repository's csrc/codec.cpp into build/cofhe_tpu_torch/ under a
content-hashed name; when no toolchain is available `get_lib()` returns
None and serialize.py uses its pure-Python twin, which gives the same
bytes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "csrc", "codec.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "cofhe_tpu_torch")


def _build() -> str | None:
    if not os.path.exists(_SRC):
        return None
    with open(_SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    out = os.path.join(BUILD_DIR, f"libcofhe_codec-{tag}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = out + f".tmp{os.getpid()}"
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)  # atomic against concurrent builds
        return out
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib():
    """Returns the loaded ctypes library or None."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)
        lib.cofhe_codec_field_sizes.restype = ctypes.c_int64
        lib.cofhe_codec_field_sizes.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
        lib.cofhe_codec_pack.restype = None
        lib.cofhe_codec_pack.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
        lib.cofhe_codec_unpack.restype = ctypes.c_int32
        lib.cofhe_codec_unpack.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
        _LIB = lib
        return _LIB


def pack_fields(limbs: np.ndarray, signs: np.ndarray) -> tuple[np.ndarray, bytes] | None:
    """(n_fields, L) int32 limbs + (n_fields,) signs -> (offset table u64,
    data bytes), or None if the native lib is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    limbs = np.ascontiguousarray(limbs, dtype=np.int32)
    signs = np.ascontiguousarray(signs, dtype=np.int32)
    n, L = limbs.shape
    sizes = np.zeros(n, dtype=np.int64)
    total = lib.cofhe_codec_field_sizes(limbs.ctypes.data, n, L, sizes.ctypes.data)
    offsets = np.zeros(n, dtype=np.uint64)
    data = np.zeros(int(total), dtype=np.uint8)
    lib.cofhe_codec_pack(limbs.ctypes.data, signs.ctypes.data, sizes.ctypes.data,
                         n, L, offsets.ctypes.data, data.ctypes.data)
    return offsets, data.tobytes()


def unpack_fields(offsets: np.ndarray, data: bytes, L: int) -> tuple[np.ndarray, np.ndarray] | None:
    """Inverse of pack_fields: -> ((n_fields, L) int32 limbs, signs)."""
    lib = get_lib()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.uint64)
    n = offsets.shape[0]
    buf = np.frombuffer(data, dtype=np.uint8)
    limbs = np.zeros((n, L), dtype=np.int32)
    signs = np.zeros(n, dtype=np.int32)
    rc = lib.cofhe_codec_unpack(offsets.ctypes.data, buf.ctypes.data, len(data),
                                n, L, limbs.ctypes.data, signs.ctypes.data)
    if rc != 0:
        return None
    return limbs, signs
