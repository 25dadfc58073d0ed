"""The port's vector ops against the JAX package on the toy parameters
(k=32, 100-bit p): TorchEngine.add_batch / scal_batch / combine_batch of
CryptoSystem(device="cpu") against the JAX package's engine
(device="cpu-jax") under the same seed and against the host oracle, the
composition tree of parallel/sharded.py, and the rest of the facade
(0-D/1-D scal, tensor add/negate, plaintext tensors, triplets, factory,
rerandomize). Inputs: tests/test_engine.py:26-56 and tests/test_sharding.py
:24,112 with ragged batches (identity padding) and the scalars 0, 1 and
M - 1. The JAX engine runs at the shapes of those tests, since each new
shape compiles for tens of seconds on the CPU. Tolerance: exact equality
(reduced forms are unique)."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofhe_tpu.api import CryptoSystem as JaxCryptoSystem
from cofhe_tpu.core.cl_hsm2k import CipherText as JCipherText
from cofhe_tpu.core.qfi import Form as JForm
from cofhe_tpu.ops import forms as jforms
from cofhe_tpu.parallel import sharded as jsharded
from cofhe_tpu_torch.api import (CryptoSystem, Device, Precision,
                                 SecurityLevel, make_cryptosystem)
from cofhe_tpu_torch.core import liss
from cofhe_tpu_torch.core.qfi import compose
from cofhe_tpu_torch.ops.forms import BForm, bform_from_forms, bform_to_forms
from cofhe_tpu_torch.parallel.sharded import _scan_tree_compose
from cofhe_tpu_torch.tensor import Tensor

torch.set_num_threads(1)


def _key(cts):
    return [(tuple(c.c1), tuple(c.c2)) for c in cts]


def _jct(ct):
    return JCipherText(JForm(*ct.c1), JForm(*ct.c2))


@pytest.fixture(scope="module")
def both(toy_cs):
    p = toy_cs.hsm2k.p
    jcs = JaxCryptoSystem(128, 32, p=p, seed=b"engine-test", device="cpu-jax")
    pcs = CryptoSystem(128, 32, p=p, seed=b"engine-test", device="cpu")
    sk = pcs.keygen()
    pk = pcs.keygen(sk)
    assert jcs.keygen() == sk and tuple(jcs.keygen(sk)) == tuple(pk)
    return jcs, pcs, sk, pk


def _decrypt(cs, sk, cts):
    return [cs.decrypt(sk, c) for c in cts]  # element-level host decrypt


def test_add_batch(both):
    jcs, pcs, sk, pk = both
    rng = random.Random(31)
    M = pcs.hsm2k.M
    a = [rng.randrange(M) for _ in range(5)]
    b = [rng.randrange(M) for _ in range(5)]
    ca, cb = pcs.encrypt_vector(pk, a), pcs.encrypt_vector(pk, b)
    out = pcs.add_ciphertext_vectors(pk, ca, cb)  # 10 of 16 rows live
    jout = jcs._engine.add_batch([_jct(c) for c in ca], [_jct(c) for c in cb])
    assert _key(out) == _key(jout)
    assert out == [pcs.hsm2k.add_ciphertexts(x, y) for x, y in zip(ca, cb)]
    assert _decrypt(pcs, sk, out) == [(x + y) % M for x, y in zip(a, b)]


def test_scal_batch(both):
    """Scalars 0, 1 and M - 1 on 3 ciphertexts (6 of 8 rows live): the JAX
    engine, the host oracle, and 0 gives the identity form."""
    jcs, pcs, sk, pk = both
    rng = random.Random(32)
    M = pcs.hsm2k.M
    vals = [rng.randrange(M) for _ in range(3)]
    scal = [0, 1, M - 1]
    cts = pcs.encrypt_vector(pk, vals)
    out = pcs.scal_ciphertext_vector(pk, scal, cts)
    jout = jcs._engine.scal_batch(scal, [_jct(c) for c in cts])
    assert _key(out) == _key(jout)
    assert out == [pcs.hsm2k.scal_ciphertext(c, s) for c, s in zip(cts, scal)]
    ident = pcs.hsm2k.identity
    assert out[0].c1 == ident and out[0].c2 == ident
    assert _decrypt(pcs, sk, out) == [v * s % M for v, s in zip(vals, scal)]


def test_scal_batch_random_scalars(both):
    """Random k-bit scalars on 5 ciphertexts (10 of 16 rows live) against
    the host oracle."""
    _, pcs, sk, pk = both
    rng = random.Random(33)
    M = pcs.hsm2k.M
    vals = [rng.randrange(M) for _ in range(5)]
    scal = [rng.randrange(M) for _ in range(5)]
    cts = pcs.encrypt_vector(pk, vals)
    out = pcs._engine.scal_batch(scal, cts)
    assert out == [pcs.hsm2k.scal_ciphertext(c, s) for c, s in zip(cts, scal)]
    assert _decrypt(pcs, sk, out) == [v * s % M for v, s in zip(vals, scal)]


@pytest.mark.parametrize("t,n_parties,combo,n", [(2, 3, (0, 1), 3),
                                                  (3, 4, (0, 2, 3), 2)])
def test_combine_batch(both, t, n_parties, combo, n):
    jcs, pcs, sk, pk = both
    rng = random.Random(34 + t)
    hsm = pcs.hsm2k
    vals = [rng.randrange(hsm.M) for _ in range(n)]
    cts = pcs.encrypt_vector(pk, vals)
    shares = pcs.keygen(sk, t, n_parties)
    sh = [shares[pm][liss.share_index_for_party(pm, combo, n_parties)]
          for pm in combo]
    pdrs = [[hsm.part_decrypt(c, s) for c in cts] for s in sh]
    got = pcs._engine.combine_batch(cts, pdrs)
    jgot = jcs._engine.combine_batch([_jct(c) for c in cts],
                                     [[JForm(*f) for f in p] for p in pdrs])
    assert got == jgot == vals
    assert got == [hsm.final_decrypt(c, [p[i] for p in pdrs])
                   for i, c in enumerate(cts)]


def test_combine_vector_routes_to_the_engine_from_its_minimum_batch(both, monkeypatch):
    _, pcs, sk, pk = both
    rng = random.Random(36)
    hsm = pcs.hsm2k
    n = pcs._engine.min_batch_encrypt
    vals = [rng.randrange(hsm.M) for _ in range(n)]
    cts = pcs.encrypt_vector(pk, vals)
    shares = pcs.keygen(sk, 2, 3)
    sh = [shares[pm][liss.share_index_for_party(pm, (0, 1), 3)] for pm in (0, 1)]
    host = CryptoSystem(128, 32, p=hsm.p, device="host")
    pdrs = [host.part_decrypt_vector(s, cts) for s in sh]
    calls = []
    orig = pcs._engine.combine_batch
    monkeypatch.setattr(pcs._engine, "combine_batch",
                        lambda c, p: calls.append(len(c)) or orig(c, p))
    assert pcs.combine_part_decryption_results_vector(cts, pdrs) == vals
    assert pcs.combine_part_decryption_results_vector(
        cts[:3], [p[:3] for p in pdrs]) == vals[:3]
    assert calls == [n]


def _stacks(hsm, t, rows, seed):
    rng = random.Random(seed)
    return [[hsm.power_of_h(rng.getrandbits(24)) for _ in range(rows)]
            for _ in range(t)]


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5])
def test_scan_tree_compose(both, t):
    """t = 1..5 parties (odd t pads with identities) against the sequential
    host compose; t = 3 at tests/test_sharding.py:24's shape also against
    the JAX package's tree."""
    jcs, pcs, _, _ = both
    rows = 2
    forms = _stacks(pcs.hsm2k, t, rows, 100 + t)
    L = pcs._engine.L
    stacks = [bform_from_forms(f, L, "cpu") for f in forms]
    stacked = BForm(*(torch.stack(xs) for xs in zip(*stacks)))
    got = bform_to_forms(_scan_tree_compose(pcs._engine.cg, stacked, t))
    for r in range(rows):
        want = forms[0][r]
        for i in range(1, t):
            want = compose(want, forms[i][r])
        assert got[r] == want, r
    if t == 3:
        jst = [jforms.bform_from_forms([JForm(*f) for f in fs], L) for fs in forms]
        jstacked = jforms.BForm(*(jnp.stack([np.asarray(getattr(s, f)) for s in jst])
                                  for f in ("a", "b_sign", "b", "c")))
        jout = jax.jit(lambda s: jsharded._scan_tree_compose(jcs._engine.cg, s, t))(jstacked)
        jgot = jforms.bform_to_forms(jax.tree.map(np.asarray, jout))
        assert [tuple(f) for f in got] == [tuple(f) for f in jgot]


# ------------------------------------------------ the facade, after test_api


def test_add_scal_negate_tensors(both):
    _, pcs, sk, pk = both
    rng = random.Random(5)
    M = pcs.hsm2k.M
    a = [rng.randrange(M) for _ in range(6)]
    b = [rng.randrange(M) for _ in range(6)]
    ca = pcs.encrypt_tensor(pk, Tensor(a, (2, 3)))
    cb = pcs.encrypt_tensor(pk, Tensor(b, (2, 3)))
    s = pcs.add_ciphertext_tensors(pk, ca, cb)
    assert s.shape == (2, 3)
    assert _decrypt(pcs, sk, s.data) == [(x + y) % M for x, y in zip(a, b)]
    sc = [rng.randrange(100) for _ in range(6)]
    scl = pcs.scal_ciphertext_tensors(pk, Tensor(sc, (6,)), Tensor(ca.data, (6,)))
    assert _decrypt(pcs, sk, scl.data) == [x * y % M for x, y in zip(sc, a)]
    ng = pcs.negate_ciphertext_tensor(pk, ca)
    assert _decrypt(pcs, sk, ng.data) == [-x % M for x in a]
    with pytest.raises(ValueError):
        pcs.add_ciphertext_tensors(pk, ca, Tensor(cb.data, (3, 2)))


def test_scal_broadcast_zero_degree_only(both):
    """0-D tensors broadcast elementwise; shaped 1-element tensors keep the
    reference's dimension checks (cpu_cryptosystem_tensor_ops.inl:281-285)."""
    _, pcs, sk, pk = both
    rng = random.Random(6)
    M = pcs.hsm2k.M
    vals = [rng.randrange(M) for _ in range(3)]
    ct = pcs.encrypt_tensor(pk, Tensor(vals, (3,)))
    out = pcs.scal_ciphertext_tensors(pk, Tensor.zero_degree(7), ct)
    assert out.shape == (3,)
    assert _decrypt(pcs, sk, out.data) == [7 * v % M for v in vals]
    ct0 = Tensor.zero_degree(pcs.encrypt(pk, vals[0]))
    out = pcs.scal_ciphertext_tensors(pk, Tensor([2, 3, 4], (3,)), ct0)
    assert _decrypt(pcs, sk, out.data) == [x * vals[0] % M for x in (2, 3, 4)]
    both0 = pcs.scal_ciphertext_tensors(pk, Tensor.zero_degree(5), ct0)
    assert pcs.decrypt(sk, both0.get_value()) == 5 * vals[0] % M
    with pytest.raises(ValueError):
        pcs.scal_ciphertext_tensors(pk, Tensor([7], (1,)), ct)
    with pytest.raises(ValueError):
        pcs.scal_ciphertext_tensors(
            pk, Tensor([7], (1, 1)), pcs.encrypt_tensor(pk, Tensor(vals, (1, 3))))


def test_plaintext_tensors_and_triplets(both):
    _, pcs, _, _ = both
    a, b = Tensor([1, 2, 3], (3,)), Tensor([10, 20, 30], (3,))
    assert pcs.add_plaintext_tensors(a, b).data == [11, 22, 33]
    assert pcs.multiply_plaintext_tensors(a, b).data == [10, 40, 90]
    neg = pcs.negate_plaintext_tensor(a)
    assert [pcs.get_float_from_plaintext(v) for v in neg.data] == [-1.0, -2.0, -3.0]
    assert pcs.negate_plain_tensor(a) == neg
    x, y, z = pcs.generate_random_beavers_triplet()
    assert z == x * y and 0 <= x < 10 and 0 <= y < 10


def test_factory_and_devices(toy_cs, monkeypatch):
    cs = make_cryptosystem(SecurityLevel.MEDIUM, 32, device=Device.CPU, p=toy_cs.hsm2k.p)
    assert (cs.sec_level, cs.k, cs.device) == (128, 32, "host")
    cs = make_cryptosystem(128, Precision.FP32, 1, device="cpu", p=toy_cs.hsm2k.p)
    assert (cs.k, cs.device) == (64, "host")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_cryptosystem(SecurityLevel.MEDIUM, 32, p=toy_cs.hsm2k.p)  # Device.GPU
    # compact mode runs on the host with no engine, whatever the device
    cs = CryptoSystem(128, 32, compact=True, device="cuda", p=toy_cs.hsm2k.p)
    assert cs._engine is None and cs.hsm2k.compact_variant()
    assert cs.serialize() == "CPUCryptoSystem 128 32 1"


@pytest.mark.parametrize("mode", ["shared", "per_op"])
def test_rerandomize_matches_the_jax_package(toy_cs, mode):
    """Enc(0) folding after add/scal draws the same randomness as the JAX
    package's facade under the same seed (its host engine: the same reduced
    forms as its JAX engine)."""
    p = toy_cs.hsm2k.p
    jcs = JaxCryptoSystem(128, 32, p=p, seed=b"rerand", device="host",
                          rerandomize=mode)
    pcs = CryptoSystem(128, 32, p=p, seed=b"rerand", device="cpu",
                       rerandomize=mode)
    sk = pcs.keygen()
    assert jcs.keygen() == sk
    pk, jpk = pcs.keygen(sk), jcs.keygen(sk)
    vals = [3, 5, 7]
    cts, jcts = pcs.encrypt_vector(pk, vals), jcs.encrypt_vector(jpk, vals)
    assert _key(cts) == _key(jcts)
    out = pcs.add_ciphertext_vectors(pk, cts, cts)
    assert _key(out) == _key(jcs.add_ciphertext_vectors(jpk, jcts, jcts))
    one = pcs.add_ciphertexts(pk, cts[0], cts[1])
    assert _key([one]) == _key([jcs.add_ciphertexts(jpk, jcts[0], jcts[1])])
    sc = pcs.scal_ciphertext(pk, 9, cts[2])
    assert _key([sc]) == _key([jcs.scal_ciphertext(jpk, 9, jcts[2])])
    if mode == "per_op":
        sv = pcs.scal_ciphertext_vector(pk, [2, 0, 4], cts)
        assert _key(sv) == _key(jcs.scal_ciphertext_vector(jpk, [2, 0, 4], jcts))
        assert _decrypt(pcs, sk, sv) == [6, 0, 28]
    assert _decrypt(pcs, sk, out) == [6, 10, 14]
    assert pcs.decrypt(sk, one) == 8 and pcs.decrypt(sk, sc) == 63
