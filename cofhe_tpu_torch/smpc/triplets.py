"""Trusted-dealer Beaver triplet generation (reference
smpc/beavers_triplet_generation.hpp:9-43): sample (a, b, a*b) plaintexts and
encrypt them as an (n, 3) ciphertext tensor with one shared randomness.
The port's copy of cofhe_tpu/smpc/triplets.py."""

from __future__ import annotations

from ..api import CryptoSystem
from ..tensor import Tensor


class BeaversTripletGenerator:
    def __init__(self, crypto_system: CryptoSystem, public_key):
        self.cs = crypto_system
        self.pk = public_key

    def generate(self, n: int) -> Tensor:
        pts = []
        for _ in range(n):
            a, b, c = self.cs.generate_random_beavers_triplet()
            pts.extend([a, b, c])
        return self.cs.encrypt_tensor(self.pk, Tensor(pts, (n, 3)))
