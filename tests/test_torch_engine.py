"""The port's slice as a whole: CryptoSystem(device="cpu") of cofhe_tpu_torch
against the JAX package's CryptoSystem(device="cpu-jax") with the same seed,
on the toy parameters (k=32, 100-bit p) and the shapes of
tests/test_engine.py:84-116.

encrypt_tensor -> scal_ciphertext_tensors (the job-stream matmul) ->
decrypt_tensor must give equal ciphertext forms and equal plaintexts, and
the plaintexts must equal the integer matmul mod 2^k. Tolerance: exact
equality (reduced forms are unique).
"""

import random

import pytest
import torch

from cofhe_tpu.api import CryptoSystem as JaxCryptoSystem
from cofhe_tpu.tensor import Tensor as JaxTensor
from cofhe_tpu_torch.api import CryptoSystem
from cofhe_tpu_torch.core.qfi import compose, neg, nupow, reduce_form
from cofhe_tpu_torch.tensor import Tensor

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both(toy_cs):
    p = toy_cs.hsm2k.p
    jcs = JaxCryptoSystem(128, 32, p=p, seed=b"engine-test", device="cpu-jax")
    pcs = CryptoSystem(128, 32, p=p, seed=b"engine-test", device="cpu")
    jsk, psk = jcs.keygen(), pcs.keygen()
    jpk, ppk = jcs.keygen(jsk), pcs.keygen(psk)
    assert jsk == psk and tuple(jpk) == tuple(ppk)
    return jcs, pcs, jsk, jpk, ppk


def _cts(t):
    return [(tuple(ct.c1), tuple(ct.c2)) for ct in t.data]


def test_slice_matches_jax(both):
    jcs, pcs, sk, jpk, ppk = both
    rng = random.Random(31)
    n, m, p = 2, 3, 2
    ctv = [rng.randrange(1000) for _ in range(n * m)]
    sv = [rng.randrange(1000) for _ in range(m * p)]
    jct = jcs.encrypt_tensor(jpk, JaxTensor(ctv, (n, m)))
    pct = pcs.encrypt_tensor(ppk, Tensor(ctv, (n, m)))
    assert _cts(pct) == _cts(jct)
    jres = jcs.scal_ciphertext_tensors(jpk, JaxTensor(sv, (m, p)), jct)
    pres = pcs.scal_ciphertext_tensors(ppk, Tensor(sv, (m, p)), pct)
    assert pres.shape == (n, p) and _cts(pres) == _cts(jres)
    jdec = jcs.decrypt_tensor(sk, jres)
    pdec = pcs.decrypt_tensor(sk, pres)
    want = [sum(ctv[i * m + j] * sv[j * p + kk] for j in range(m)) % pcs.hsm2k.M
            for i in range(n) for kk in range(p)]
    assert list(pdec.data) == list(jdec.data) == want


def test_engine_compose_and_part_decrypt(both):
    """The batched encrypt's compose (ragged batch: identity padding) and the
    wNAF part_decrypt (negative share too) against the host oracle."""
    _, pcs, _, _, ppk = both
    rng = random.Random(5)
    hsm = pcs.hsm2k
    f1 = [nupow(hsm.h, rng.getrandbits(40)) for _ in range(6)]
    f2 = [hsm.power_of_f(rng.getrandbits(32)) for _ in range(6)]
    got = pcs._engine.compose_forms_batch(f1, f2)
    assert [tuple(f) for f in got] == [tuple(compose(a, b)) for a, b in zip(f1, f2)]
    cts = pcs.encrypt_vector(ppk, [rng.randrange(hsm.M) for _ in range(3)])
    for share in (rng.getrandbits(24), -rng.getrandbits(24)):
        pd = pcs.part_decrypt_vector(share, cts)
        oracle = [nupow(ct.c1, abs(share)) for ct in cts]
        if share < 0:
            oracle = [reduce_form(neg(f)) for f in oracle]
        assert [tuple(f) for f in pd] == [tuple(f) for f in oracle]
