"""Serialization for keys, plaintexts, ciphertexts and tensors.

Binary tensor formats are byte-compatible with the reference's custom packed
format (cpu_cryptosystem.inl:229-635):

    [u32 ndim][u32 shape...]
    [u64 offset-table: one entry per bignum, MSB = sign bit (set when the
     value is <= 0, i.e. BICYCL sgn() != 1), low 63 bits = byte offset into
     the data region]
    [bignum bytes: little-endian magnitude (mpz_export order=-1 size=1
     endian=-1), each field occupying bitlength/8 + 1 bytes]

Fields per element: plaintext = 1, ciphertext = 6 (c1.a,b,c,c2.a,b,c),
partial-decryption result = 3 (a,b,c).

Scalar/text formats are the reference's space-separated decimal strings
(cpu_cryptosystem.inl:124-227).

The port's copy of cofhe_tpu/serialize.py: the bytes are the JAX package's.
Tensor fields go through the native codec (native.py) when it builds, with
the limb conversion of ops/limb.py, else through the pure-Python packer.
"""

from __future__ import annotations

import struct

import numpy as np

from . import native
from .core.cl_hsm2k import CipherText
from .core.qfi import Form
from .ops import limb as lb
from .tensor import Tensor

_SIGN_BIT = 1 << 63
_OFF_MASK = _SIGN_BIT - 1


def _field_size(v: int) -> int:
    """mpz_sizeinbase(v, 2) / 8 + 1  (sizeinbase(0) == 1)."""
    bl = abs(v).bit_length()
    if bl == 0:
        bl = 1
    return bl // 8 + 1


def _export_bytes(v: int, size: int) -> bytes:
    """Little-endian magnitude, zero padded to `size` (mpz_export writes
    ceil(bits/8) bytes; the trailing pad byte(s) stay zero)."""
    mag = abs(v)
    raw = mag.to_bytes((mag.bit_length() + 7) // 8, "little") if mag else b""
    return raw + b"\x00" * (size - len(raw))


def _serialize_fields_tensor(t: Tensor, fields_of) -> bytes:
    ndim = t.ndim
    shape = t.shape
    all_fields: list[int] = []
    for elem in t.data:
        all_fields.extend(fields_of(elem))
    header = struct.pack("<I", ndim) + b"".join(struct.pack("<I", d) for d in shape)
    native = _native_pack(all_fields)
    if native is not None:
        return header + native
    offsets = []
    off = 0
    sizes = []
    for v in all_fields:
        entry = off | (_SIGN_BIT if v <= 0 else 0)
        offsets.append(entry)
        sz = _field_size(v)
        sizes.append(sz)
        off += sz
    table = b"".join(struct.pack("<Q", e) for e in offsets)
    data = b"".join(_export_bytes(v, sz) for v, sz in zip(all_fields, sizes))
    return header + table + data


def _native_pack(all_fields: list[int]) -> bytes | None:
    """Offset table + data region via the C++ codec (csrc/codec.cpp)."""
    if not all_fields or native.get_lib() is None:
        return None
    max_bits = max(abs(v).bit_length() for v in all_fields)
    L = max_bits // 16 + 1
    signs, limbs = lb.ints_to_signed(all_fields, L)
    packed = native.pack_fields(limbs, signs)
    if packed is None:
        return None
    offsets, data = packed
    return offsets.tobytes() + data


def _deserialize_fields_tensor(blob: bytes, fields_per_elem: int, build):
    ndim = struct.unpack_from("<I", blob, 0)[0]
    shape = tuple(struct.unpack_from("<I", blob, 4 + 4 * i)[0] for i in range(ndim))
    num = 1
    for d in shape:
        num *= d
    pos = 4 + 4 * ndim
    nf = num * fields_per_elem
    data_start = pos + 8 * nf
    values = _native_unpack(blob, pos, nf, data_start)
    if values is None:
        offsets = [struct.unpack_from("<Q", blob, pos + 8 * i)[0] for i in range(nf)]
        values = []
        for i in range(nf):
            start = offsets[i] & _OFF_MASK
            end = (offsets[i + 1] & _OFF_MASK) if i + 1 < nf else len(blob) - data_start
            v = int.from_bytes(blob[data_start + start:data_start + end], "little")
            if offsets[i] & _SIGN_BIT:
                v = -v
            values.append(v)
    elems = [build(values[i * fields_per_elem:(i + 1) * fields_per_elem]) for i in range(num)]
    return Tensor(elems, shape)


def _native_unpack(blob: bytes, pos: int, nf: int, data_start: int):
    if nf == 0:
        return []
    if native.get_lib() is None:
        return None
    offsets = np.frombuffer(blob, dtype=np.uint64, count=nf, offset=pos)
    data = blob[data_start:]
    # L from the largest field
    offs = offsets.astype(np.int64) & _OFF_MASK
    ends = np.concatenate([offs[1:], np.asarray([len(data)], dtype=np.int64)])
    max_bytes = int((ends - offs).max()) if nf else 1
    L = (max_bytes + 1) // 2 + 1
    out = native.unpack_fields(offsets, data, L)
    if out is None:
        return None
    limbs, signs = out
    return lb.limbs_to_ints(limbs, signs)


# -- tensors ----------------------------------------------------------------

def serialize_plaintext_tensor(t: Tensor) -> bytes:
    return _serialize_fields_tensor(t, lambda v: (v,))


def deserialize_plaintext_tensor(blob: bytes) -> Tensor:
    return _deserialize_fields_tensor(blob, 1, lambda f: f[0])


def serialize_ciphertext_tensor(t: Tensor) -> bytes:
    return _serialize_fields_tensor(
        t, lambda ct: (ct.c1.a, ct.c1.b, ct.c1.c, ct.c2.a, ct.c2.b, ct.c2.c))


def deserialize_ciphertext_tensor(blob: bytes) -> Tensor:
    return _deserialize_fields_tensor(
        blob, 6, lambda f: CipherText(Form(f[0], f[1], f[2]), Form(f[3], f[4], f[5])))


def serialize_pdr_tensor(t: Tensor) -> bytes:
    return _serialize_fields_tensor(t, lambda q: (q.a, q.b, q.c))


def deserialize_pdr_tensor(blob: bytes) -> Tensor:
    return _deserialize_fields_tensor(blob, 3, lambda f: Form(f[0], f[1], f[2]))


# -- scalars (text, reference cpu_cryptosystem.inl:139-227) -----------------

def serialize_secret_key(sk: int) -> str:
    return str(sk)


def deserialize_secret_key(s: str) -> int:
    return int(s)


def serialize_secret_key_share(sks: int) -> str:
    return str(sks)


def deserialize_secret_key_share(s: str) -> int:
    return int(s)


def serialize_public_key(pk: Form) -> str:
    return f"{pk.a} {pk.b} {pk.c}"


def deserialize_public_key(s: str) -> Form:
    a, b, c = (int(x) for x in s.split())
    return Form(a, b, c)


def serialize_plaintext(pt: int) -> str:
    return str(pt)


def deserialize_plaintext(s: str) -> int:
    return int(s)


def serialize_ciphertext(ct: CipherText) -> str:
    return f"{ct.c1.a} {ct.c1.b} {ct.c1.c} {ct.c2.a} {ct.c2.b} {ct.c2.c}"


def deserialize_ciphertext(s: str) -> CipherText:
    v = [int(x) for x in s.split()]
    return CipherText(Form(v[0], v[1], v[2]), Form(v[3], v[4], v[5]))


def serialize_pdr(q: Form) -> str:
    return f"{q.a} {q.b} {q.c}"


def deserialize_pdr(s: str) -> Form:
    a, b, c = (int(x) for x in s.split())
    return Form(a, b, c)
