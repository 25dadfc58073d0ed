"""Deterministic DRBG used wherever the reference uses BICYCL::RandGen.

SHA-256 counter-mode stream. Deterministic + seedable so that (a) threshold
keygen/test vectors are reproducible and (b) all parties derive identical
public parameters from (security_level, k) alone, which the reference's
`CPUCryptoSystem::deserialize` (cpu_cryptosystem.inl:129-137) implicitly
requires (it reconstructs the cryptosystem from those two integers only).
"""

from __future__ import annotations

import hashlib
import os


class RandGen:
    def __init__(self, seed: bytes | int | None = None):
        if seed is None:
            seed = os.urandom(32)
        if isinstance(seed, int):
            seed = seed.to_bytes((seed.bit_length() + 7) // 8 or 1, "little")
        self._key = hashlib.sha256(b"cofhe-tpu-randgen-v1:" + seed).digest()
        self._counter = 0
        self._buf = b""

    def random_bytes(self, n: int) -> bytes:
        while len(self._buf) < n:
            block = hashlib.sha256(self._key + self._counter.to_bytes(8, "little")).digest()
            self._counter += 1
            self._buf += block
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def random_bits(self, nbits: int) -> int:
        nbytes = (nbits + 7) // 8
        v = int.from_bytes(self.random_bytes(nbytes), "little")
        return v >> (nbytes * 8 - nbits)

    def random_mpz(self, bound: int) -> int:
        """Uniform in [0, bound). Mirrors BICYCL RandGen::random_mpz."""
        if bound <= 0:
            return 0
        nbits = bound.bit_length()
        while True:
            v = self.random_bits(nbits)
            if v < bound:
                return v

    def random_prime(self, nbits: int) -> int:
        from .intmath import is_prime

        while True:
            v = self.random_bits(nbits) | (1 << (nbits - 1)) | 1
            if is_prime(v):
                return v
