"""Compact mode of the port's facade (CryptoSystem(compact=True)) on the toy
parameters (k=32, 100-bit p): tests/test_clhsm2k.py's compact facade case
run through the port, and the port's keys, ciphertexts and homomorphic
results for seed b"cv" against the JAX package's facade. Compact mode has
no engine in either package (c1 in Cl(Delta_K), c2 in Cl(Delta)): every op
runs element by element on the host. Tolerance: exact equality of keys,
forms and plaintexts."""

import random

import pytest

from cofhe_tpu.api import CryptoSystem as JaxCryptoSystem
from cofhe_tpu.tensor import Tensor as JTensor
from cofhe_tpu_torch.api import CryptoSystem
from cofhe_tpu_torch.tensor import Tensor


def _forms(cts):
    return [(tuple(c.c1), tuple(c.c2)) for c in cts]


@pytest.fixture(scope="module")
def both(toy_hsm):
    jcs = JaxCryptoSystem(128, 32, compact=True, p=toy_hsm.p, seed=b"cv")
    pcs = CryptoSystem(128, 32, compact=True, p=toy_hsm.p, seed=b"cv")
    jsk, psk = jcs.keygen(), pcs.keygen()
    jpk, ppk = jcs.keygen(jsk), pcs.keygen(psk)
    return jcs, pcs, (jsk, jpk), (psk, ppk)


def test_compact_variant_api_facade(toy_hsm):
    """tests/test_clhsm2k.py::test_compact_variant_api_facade on the port
    (its device default, "cuda", builds nothing in compact mode)."""
    cs = CryptoSystem(128, 32, compact=True, p=toy_hsm.p, seed=b"cv")
    assert cs._engine is None
    sk = cs.keygen()
    pk = cs.keygen(sk)
    vals = [random.Random(3).randrange(cs.hsm2k.M) for _ in range(4)]
    ct = cs.encrypt_tensor(pk, Tensor(vals, (2, 2)))
    assert cs.decrypt_tensor(sk, ct).data == vals
    assert "1" in cs.serialize().split()[-1]
    cs2 = CryptoSystem.deserialize(cs.serialize())
    assert cs2.hsm2k.compact_variant() and cs2._engine is None


def test_compact_keys_and_ciphertexts_match_the_jax_facade(both):
    jcs, pcs, (jsk, jpk), (psk, ppk) = both
    assert jsk == psk and tuple(jpk) == tuple(ppk)
    assert ppk.disc == pcs.hsm2k.DeltaK  # pk stays in Cl(Delta_K)
    vals = [5, 0, 2 ** 32 - 1, 77, 123456, 9]
    jct = jcs.encrypt_tensor(jpk, JTensor(vals, (2, 3)))
    pct = pcs.encrypt_tensor(ppk, Tensor(vals, (2, 3)))
    assert _forms(pct.data) == _forms(jct.data)
    assert _forms([pcs.encrypt(ppk, 42)]) == _forms([jcs.encrypt(jpk, 42)])
    assert pcs.decrypt_tensor(psk, pct).data == vals


def test_compact_homomorphic_ops_match_the_jax_facade(both):
    jcs, pcs, (_, jpk), (psk, ppk) = both
    M = pcs.hsm2k.M
    a, b = [3, 8, 1, 6], [2, 7, 4, 9]
    ja, jb = (jcs.encrypt_tensor(jpk, JTensor(v, (2, 2))) for v in (a, b))
    pa, pb = (pcs.encrypt_tensor(ppk, Tensor(v, (2, 2))) for v in (a, b))
    added = pcs.add_ciphertext_vectors(ppk, pa.data, pb.data)
    assert _forms(added) == _forms(jcs.add_ciphertext_vectors(jpk, ja.data, jb.data))
    scaled = pcs.scal_ciphertext_vector(ppk, [0, 1, M - 1, 5], pa.data)
    assert _forms(scaled) == _forms(jcs.scal_ciphertext_vector(jpk, [0, 1, M - 1, 5], ja.data))
    pt = [1, 2, 3, 4]
    prod = pcs.scal_ciphertext_tensors(ppk, Tensor(pt, (2, 2)), pa)
    jprod = jcs.scal_ciphertext_tensors(jpk, JTensor(pt, (2, 2)), ja)
    assert _forms(prod.data) == _forms(jprod.data)
    assert pcs.decrypt_tensor(psk, prod).data == [(a[0] * 1 + a[1] * 3) % M, (a[0] * 2 + a[1] * 4) % M,
                                                  (a[2] * 1 + a[3] * 3) % M, (a[2] * 2 + a[3] * 4) % M]
    assert pcs.decrypt_vector(psk, added) == [(x + y) % M for x, y in zip(a, b)]


def test_compact_threshold_decrypt(both):
    _, pcs, _, (psk, ppk) = both
    shares = pcs.keygen(psk, 2, 3)
    from cofhe_tpu_torch.core import liss

    sh = [shares[q][liss.share_index_for_party(q, (0, 2), 3)] for q in (0, 2)]
    cts = pcs.encrypt_vector(ppk, [11, 22, 33])
    pdrs = [pcs.part_decrypt_vector(s, cts) for s in sh]
    assert all(f.disc == pcs.hsm2k.Delta for f in pdrs[0])  # PDRs are lifted
    assert pcs.combine_part_decryption_results_vector(cts, pdrs) == [11, 22, 33]
