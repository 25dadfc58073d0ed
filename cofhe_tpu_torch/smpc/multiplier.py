"""Beaver-triplet ciphertext x ciphertext multiplication (reference
smpc/ciphertext_multiplications.hpp:8-164).

Protocol per element (multiply_ciphertexts, :16-39): with triplet
(Enc(a), Enc(b), Enc(ab)) and inputs x, y:
    eps   = Dec(x - a)            (interactive threshold decrypt)
    delta = Dec(y - b)
    z     = Enc(eps*delta) + eps*Enc(b) + delta*Enc(a) + Enc(ab)
The tensor variant broadcasts ct1 (n,m) x ct2 (m,p) to n*m*p element pairs,
runs ONE vector Beaver round (a single fan-out decrypt for all pairs), then
accumulates rows into the (n, p) result (:41-160).

The port's copy of cofhe_tpu/smpc/multiplier.py, bound to the port's
facade: on "cuda" every vector op of the data plane is a batched compose2
or Yao ladder on the card.
"""

from __future__ import annotations

from ..tensor import Tensor
from .client import SMPCClient


class SMPCCipherTextMultiplier:
    def __init__(self, smpc_client: SMPCClient, public_key):
        self.smpc = smpc_client
        self.cs = smpc_client.cs
        self.pk = public_key

    def multiply_ciphertexts(self, ct1, ct2):
        res = self._beaver_batch([ct1], [ct2])
        return res[0]

    def _beaver_batch(self, xs: list, ys: list) -> list:
        """One Beaver round over a batch of ciphertext pairs. The local data
        plane is fully batched through the engine (vector ops), matching the
        reference's OpenMP vector arms (ciphertext_multiplications.hpp:
        115-160) — one add_vectors for the diffs, one decrypt fan-out, one
        batch-encrypt + two scal_vectors + two add_vectors to reassemble."""
        cs, pk = self.cs, self.pk
        n = len(xs)
        triplets = self.smpc.get_beavers_triplets(n)
        eas = [t[0] for t in triplets]
        ebs = [t[1] for t in triplets]
        ecs = [t[2] for t in triplets]
        # x - a, y - b (homomorphic subtraction via O(1) group inversion)
        neg = [cs.negate_ciphertext(pk, c) for c in eas + ebs]
        diffs = cs.add_ciphertext_vectors(pk, xs + ys, neg)
        # single interactive decrypt round
        opened = self.smpc.decrypt_tensor(Tensor(diffs, (len(diffs),)))
        M = cs.hsm2k.M
        eps = [v % M for v in opened[:n]]
        delta = [v % M for v in opened[n:]]
        # z = Enc(eps*delta) + eps*Enc(b) + delta*Enc(a) + Enc(ab)
        z = cs.encrypt_vector(pk, [e * d % M for e, d in zip(eps, delta)])
        t1 = cs.scal_ciphertext_vector(pk, eps, ebs)
        t2 = cs.scal_ciphertext_vector(pk, delta, eas)
        z = cs.add_ciphertext_vectors(pk, z, t1)
        z = cs.add_ciphertext_vectors(pk, z, t2)
        return cs.add_ciphertext_vectors(pk, z, ecs)

    def multiply_ciphertext_tensors(self, ct1: Tensor, ct2: Tensor) -> Tensor:
        """(n, m) x (m, p) -> (n, p) via one broadcast Beaver round plus row
        accumulation (reference :41-113)."""
        cs, pk = self.cs, self.pk
        if ct1.ndim != 2 or ct2.ndim != 2:
            raise ValueError("tensors must be 2-D matrices")
        n, m = ct1.shape
        m2, p = ct2.shape
        if m != m2:
            raise ValueError(f"matmul shape mismatch {ct1.shape} x {ct2.shape}")
        xs, ys = [], []
        for i in range(n):
            for j in range(m):
                for k in range(p):
                    xs.append(ct1.at(i, j))
                    ys.append(ct2.at(j, k))
        prods = self._beaver_batch(xs, ys)
        # batched log-depth row accumulation over j (one add_vectors per
        # tree level instead of n*p*(m-1) host-sequential composes)
        cur, m_cur = prods, m
        while m_cur > 1:
            half, odd = m_cur // 2, m_cur % 2
            A, B, keep = [], [], []
            for i in range(n):
                base = i * m_cur * p
                for j in range(half):
                    A.extend(cur[base + (2 * j) * p:base + (2 * j + 1) * p])
                    B.extend(cur[base + (2 * j + 1) * p:base + (2 * j + 2) * p])
                if odd:
                    keep.extend(cur[base + (m_cur - 1) * p:base + m_cur * p])
            comp = cs.add_ciphertext_vectors(pk, A, B)
            nxt, ci, ki = [], 0, 0
            for i in range(n):
                nxt.extend(comp[ci:ci + half * p])
                ci += half * p
                if odd:
                    nxt.extend(keep[ki:ki + p])
                    ki += p
            cur, m_cur = nxt, half + odd
        return Tensor(cur, (n, p))
