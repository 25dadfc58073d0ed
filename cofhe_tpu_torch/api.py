"""CryptoSystem facade of the port: the CL_HSM2k operations that the
encrypt -> homomorphic matmul -> decrypt path uses, plus the element-level
operations (host code).

Batched work dispatches to an engine chosen by `device`:

  * "cuda" (default) - TorchEngine on the GPU, with the Hopper kernels;
                       raises when CUDA is not available;
  * "cpu"            - TorchEngine on the CPU, with the kernels' plain torch
                       versions (the tests' path);
  * "host"           - the GMP host backend (ops/hostgmp.py GmpEngine).

Ciphertexts and results are bit-identical across devices, and with the JAX
package's CryptoSystem for the same seed (unique reduced forms).
"""

from __future__ import annotations

from typing import Sequence

from .core import liss
from .core.cl_hsm2k import CLHSM2k, CipherText
from .core.fixedpoint import FixedPointCodec
from .core.qfi import Form
from .core.rng import RandGen
from .tensor import Tensor


class CryptoSystem:
    """CL_HSM2k cryptosystem; tensor ops run on `device`."""

    def __init__(self, security_level: int, k: int, device: str = "cuda",
                 seed: bytes | None = None, p: int | None = None):
        self.hsm2k = CLHSM2k(security_level, k, p=p)
        self.sec_level = security_level
        self.k = k
        self.codec = FixedPointCodec(k)
        self.rand_gen = RandGen(seed)
        self.device = device
        if device == "host":
            from .ops.hostgmp import GmpEngine

            self._engine = GmpEngine(self.hsm2k)
        else:
            from .ops.engine import TorchEngine

            self._engine = TorchEngine(self.hsm2k, device=device)

    # ------------------------------------------------------------------ keys
    def keygen(self, *args):
        """keygen() -> sk; keygen(sk) -> pk; keygen(sk, t, n) -> shares."""
        if len(args) == 0:
            return self.hsm2k.keygen(self.rand_gen)
        if len(args) == 1:
            return self.hsm2k.pk_from_sk(args[0])
        sk, threshold, num_parties = args
        return liss.share_secret(sk, num_parties, threshold,
                                 self.hsm2k.encrypt_randomness_bound(),
                                 self.rand_gen)

    # --------------------------------------------------------------- element
    def encrypt(self, pk: Form, pt: int) -> CipherText:
        return self.hsm2k.encrypt(pk, pt % self.hsm2k.M, self.rand_gen)

    def decrypt(self, sk: int, ct: CipherText) -> int:
        return self.hsm2k.decrypt(sk, ct)

    def part_decrypt(self, sks: int, ct: CipherText) -> Form:
        return self.hsm2k.part_decrypt(ct, sks)

    def combine_part_decryption_results(self, ct: CipherText,
                                        pdrs: Sequence[Form]) -> int:
        return self.hsm2k.final_decrypt(ct, list(pdrs))

    def add_ciphertexts(self, pk: Form, ct1: CipherText,
                        ct2: CipherText) -> CipherText:
        return self.hsm2k.add_ciphertexts(ct1, ct2)

    def scal_ciphertext(self, pk: Form, s: int, ct: CipherText) -> CipherText:
        if s < 0:
            raise ValueError("plaintext scalar must be non-negative")
        return self.hsm2k.scal_ciphertext(ct, s)

    def negate_ciphertext(self, pk: Form, ct: CipherText) -> CipherText:
        return self.hsm2k.negate_ciphertext(ct)

    # ------------------------------------------------------------- plaintext
    def generate_random_plaintext(self) -> int:
        return self.rand_gen.random_mpz(self.hsm2k.cleartext_bound())

    def add_plaintexts(self, pt1: int, pt2: int) -> int:
        return pt1 + pt2

    def multiply_plaintexts(self, pt1: int, pt2: int) -> int:
        return pt1 * pt2

    def negate_plaintext(self, pt: int) -> int:
        return self.codec.encode(-self.codec.decode(pt))

    def make_plaintext(self, value: float) -> int:
        return self.codec.encode(value)

    def get_float_from_plaintext(self, pt: int) -> float:
        return self.codec.decode(pt)

    # --------------------------------------------------------------- vectors
    def encrypt_vector(self, pk: Form, pts: Sequence[int]) -> list[CipherText]:
        return self._encrypt_batch(pk, list(pts))

    def decrypt_vector(self, sk: int, cts: Sequence[CipherText]) -> list[int]:
        return self._engine.decrypt_batch(sk, list(cts))

    def part_decrypt_vector(self, sks: int,
                            cts: Sequence[CipherText]) -> list[Form]:
        return self._engine.part_decrypt_batch(sks, list(cts))

    def combine_part_decryption_results_vector(self, cts,
                                               pdrs_per_party) -> list[int]:
        """pdrs_per_party: list over parties of per-element PDR lists
        (element-level host combine)."""
        return [self.hsm2k.final_decrypt(ct, [p[i] for p in pdrs_per_party])
                for i, ct in enumerate(cts)]

    # --------------------------------------------------------------- tensors
    def encrypt_tensor(self, pk: Form, pt: Tensor) -> Tensor:
        return Tensor(self._encrypt_batch(pk, pt.data), pt.shape)

    def decrypt_tensor(self, sk: int, ct: Tensor) -> Tensor:
        return Tensor(self.decrypt_vector(sk, ct.data), ct.shape)

    def part_decrypt_tensor(self, sks: int, ct: Tensor) -> Tensor:
        return Tensor(self.part_decrypt_vector(sks, ct.data), ct.shape)

    def combine_part_decryption_results_tensor(self, ct: Tensor,
                                               pdrs: Sequence[Tensor]) -> Tensor:
        vals = self.combine_part_decryption_results_vector(
            ct.data, [p.data for p in pdrs])
        return Tensor(vals, pdrs[0].shape)

    def scal_ciphertext_tensors(self, pk, s: Tensor, cts: Tensor) -> Tensor:
        """(m, p) x (n, m) -> (n, p) homomorphic matmul:
        res[i,k] = Enc(0) + sum_j s[j,k] * ct[i,j]. The 0-D and 1-D forms
        of the JAX package's facade are not ported yet."""
        if s.ndim != 2 or cts.ndim != 2:
            raise NotImplementedError(
                "the port runs the 2-D matmul form only; 0-D and 1-D "
                "scalings need the batched scal path, not ported yet")
        n, m = cts.shape
        m2, p = s.shape
        if m != m2:
            raise ValueError(f"matmul shape mismatch: ct {cts.shape} x s {s.shape}")
        if any(x < 0 for x in s.data):
            raise ValueError("plaintext scalar must be non-negative")
        zero = self.encrypt(pk, 0)
        return self._engine.scal_matmul(s, cts, zero)

    # ----------------------------------------------------------- primitives
    def _encrypt_batch(self, pk: Form, pts: list[int]) -> list[CipherText]:
        """Shared-randomness batch encryption: one r per batch, c1 = h^r and
        pk^r on the host, the per-element c2 = pk^r * f^m composes batched
        on the engine (element-level on the host below its minimum batch)."""
        r = self.rand_gen.random_mpz(self.hsm2k.encrypt_randomness_bound())
        c1 = self.hsm2k.power_of_h(r)
        pkr = self.hsm2k.nupow(pk, r)
        if len(pts) >= getattr(self._engine, "min_batch_encrypt", 0):
            fms = [self.hsm2k.power_of_f(pt % self.hsm2k.M) for pt in pts]
            c2s = self._engine.compose_forms_batch([pkr] * len(pts), fms)
            return [CipherText(c1, c2) for c2 in c2s]
        return [self.hsm2k.encrypt_with_parts(pt % self.hsm2k.M, c1, pkr)
                for pt in pts]
