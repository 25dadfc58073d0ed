"""The port's serialization (cofhe_tpu_torch/serialize.py, native.py) against
the JAX package's: the same tensors and scalars give the same bytes, through
the native codec and through the pure-Python packer, and round-trip.
Inputs: random fields of up to 900 bits, the negative fields and the
field-size boundary of tests/test_golden_bytes.py, and ciphertexts and
part-decryptions of the toy cryptosystem (k=32, 100-bit p). Tolerance:
exact equality of bytes and values."""

import os
import random

import pytest
import torch

from cofhe_tpu import serialize as jser
from cofhe_tpu.core.cl_hsm2k import CipherText as JCipherText
from cofhe_tpu.core.qfi import Form as JForm
from cofhe_tpu.tensor import Tensor as JTensor
from cofhe_tpu_torch import native, serialize as ser
from cofhe_tpu_torch.api import CryptoSystem
from cofhe_tpu_torch.core.cl_hsm2k import CipherText
from cofhe_tpu_torch.core.qfi import Form
from cofhe_tpu_torch.tensor import Tensor

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def toy(toy_cs):
    cs = CryptoSystem(128, 32, p=toy_cs.hsm2k.p, seed=b"ser-test", device="host")
    sk = cs.keygen()
    pk = cs.keygen(sk)
    cts = cs.encrypt_vector(pk, [0, 1, 77, cs.hsm2k.M - 1, 5, 6])
    return cs, sk, pk, cts


def _jct(ct):
    return JCipherText(JForm(*ct.c1), JForm(*ct.c2))


def _tensors(toy):
    """(port tensor, JAX tensor, port serializer, JAX serializer, port
    deserializer) for every tensor kind."""
    cs, sk, _, cts = toy
    rng = random.Random(55)
    vals = [rng.getrandbits(rng.randrange(1, 900)) * rng.choice((1, -1))
            for _ in range(20)]
    vals += [0, -5, -(1 << 100), 1 << 100, 255, 256, -65536, 5, 300]
    pdrs = cs.part_decrypt_vector(sk, cts) + [Form(2, -1, 13)]
    return [
        (Tensor(vals, (len(vals),)), JTensor(vals, (len(vals),)),
         ser.serialize_plaintext_tensor, jser.serialize_plaintext_tensor,
         ser.deserialize_plaintext_tensor),
        (Tensor(cts, (3, 2)), JTensor([_jct(c) for c in cts], (3, 2)),
         ser.serialize_ciphertext_tensor, jser.serialize_ciphertext_tensor,
         ser.deserialize_ciphertext_tensor),
        (Tensor(pdrs, (len(pdrs),)),
         JTensor([JForm(*f) for f in pdrs], (len(pdrs),)),
         ser.serialize_pdr_tensor, jser.serialize_pdr_tensor,
         ser.deserialize_pdr_tensor),
    ]


def _no_native(monkeypatch):
    for mod in (ser, jser):
        monkeypatch.setattr(mod, "_native_pack", lambda fields: None)
        monkeypatch.setattr(mod, "_native_unpack", lambda *a: None)


@pytest.mark.parametrize("path", ["native", "python"])
def test_tensor_bytes_equal_the_jax_package(toy, path, monkeypatch):
    if path == "native":
        if native.get_lib() is None:
            pytest.fail("the native codec did not build (g++ missing)")
    else:
        _no_native(monkeypatch)
    for t, jt, enc, jenc, dec in _tensors(toy):
        blob = enc(t)
        assert blob == jenc(jt)
        assert dec(blob) == t


def test_native_and_python_paths_agree(toy, monkeypatch):
    blobs = [enc(t) for t, _, enc, _, _ in _tensors(toy)]
    _no_native(monkeypatch)
    assert [enc(t) for t, _, enc, _, _ in _tensors(toy)] == blobs


def test_native_codec_builds_under_build_dir():
    lib = native.get_lib()
    assert lib is not None
    assert os.path.dirname(lib._name) == native.BUILD_DIR


@pytest.mark.parametrize("path", ["native", "python"])
def test_golden_vectors(path, monkeypatch):
    """tests/test_golden_bytes.py's negative fields and field-size boundary
    through both packages."""
    if path == "python":
        _no_native(monkeypatch)
    cases = [
        (Tensor([5, 0, 300], (3,)), JTensor([5, 0, 300], (3,)),
         ser.serialize_plaintext_tensor, jser.serialize_plaintext_tensor),
        (Tensor([255, 256], (2,)), JTensor([255, 256], (2,)),
         ser.serialize_plaintext_tensor, jser.serialize_plaintext_tensor),
        (Tensor([Form(2, -1, 13)], (1,)), JTensor([JForm(2, -1, 13)], (1,)),
         ser.serialize_pdr_tensor, jser.serialize_pdr_tensor),
    ]
    ct = CipherText(Form(1, 0, 7), Form(3, -2, 11))
    cases.append((Tensor([ct, ct], (2, 1)), JTensor([_jct(ct)] * 2, (2, 1)),
                  ser.serialize_ciphertext_tensor, jser.serialize_ciphertext_tensor))
    for t, jt, enc, jenc in cases:
        assert enc(t) == jenc(jt)
    # the field-size boundary: 255 takes 8 // 8 + 1 = 2 bytes
    assert ser.serialize_plaintext_tensor(cases[1][0])[-4:] == bytes([0xFF, 0, 0, 1])


def test_scalar_text_formats_equal_the_jax_package(toy):
    cs, sk, pk, cts = toy
    pdr = cs.part_decrypt(sk, cts[2])
    shares = cs.keygen(sk, 2, 3)
    pairs = [
        (cs.serialize_secret_key(sk), jser.serialize_secret_key(sk)),
        (cs.serialize_secret_key_share(shares[0][0]),
         jser.serialize_secret_key_share(shares[0][0])),
        (cs.serialize_public_key(pk), jser.serialize_public_key(JForm(*pk))),
        (cs.serialize_plaintext(123), jser.serialize_plaintext(123)),
        (cs.serialize_ciphertext(cts[2]), jser.serialize_ciphertext(_jct(cts[2]))),
        (cs.serialize_part_decryption_result(pdr), jser.serialize_pdr(JForm(*pdr))),
    ]
    for got, want in pairs:
        assert got == want
    assert cs.deserialize_secret_key(pairs[0][0]) == sk
    assert cs.deserialize_secret_key_share(pairs[1][0]) == shares[0][0]
    assert cs.deserialize_public_key(pairs[2][0]) == pk
    assert cs.deserialize_plaintext(pairs[3][0]) == 123
    assert cs.deserialize_ciphertext(pairs[4][0]) == cts[2]
    assert cs.deserialize_part_decryption_result(pairs[5][0]) == pdr


def test_cryptosystem_string_and_tensor_staticmethods(toy):
    cs, sk, _, cts = toy
    assert cs.serialize() == "CPUCryptoSystem 128 32 0"
    cs2 = CryptoSystem.deserialize(cs.serialize(), device="host")
    assert (cs2.sec_level, cs2.k) == (128, 32)
    t = Tensor(cts[:4], (2, 2))
    assert cs.deserialize_ciphertext_tensor(cs.serialize_ciphertext_tensor(t)) == t
    pd = cs.part_decrypt_tensor(sk, t)
    assert cs.deserialize_part_decryption_result_tensor(
        cs.serialize_part_decryption_result_tensor(pd)) == pd
    pt = Tensor([1, -2, 3], (3,))
    assert cs.deserialize_plaintext_tensor(cs.serialize_plaintext_tensor(pt)) == pt
