"""Float <-> Z/2^k fixed-point codec.

Same semantics as the reference's map_to_positive / map_back
(cpu_cryptosystem.inl:49-87): scale by `scaling_factor` (reference default
2^0 = 1, cpu_cryptosystem.hpp:155-158), truncate toward zero, and wrap
negatives into the upper half [M/2, M). Unlike the reference (which routes
through 64-bit-precision mpf and silently loses low bits for k > 64), the
wrap here is exact integer arithmetic.
"""

from __future__ import annotations


class FixedPointCodec:
    def __init__(self, k: int, scale_bits: int = 0):
        self.k = k
        self.M = 1 << k
        self.scale = 1 << scale_bits
        self.scale_bits = scale_bits

    def encode(self, x: float) -> int:
        scaled = int(x * self.scale)  # truncation toward zero, like mpz_set_f
        if x < 0:
            scaled += self.M
        return scaled % self.M

    def decode(self, v: int) -> float:
        v %= self.M
        if v < self.M // 2:
            return v / self.scale
        return (v - self.M) / self.scale
