"""CryptoSystem facade of the port: the operation surface of the reference's
`CryptoSystemConcept` (cofhe.hpp:18-75) as the JAX package's
cofhe_tpu/api.py has it.

Element/vector/tensor variants of keygen / encrypt / decrypt / part_decrypt /
combine / add / scal / negate / plaintext arithmetic / fixed-point codec /
serialization. Batched work dispatches to an engine chosen by `device`:

  * "cuda" (default) - TorchEngine on the GPU, with the Hopper kernels;
                       raises when CUDA is not available;
  * "cpu"            - TorchEngine on the CPU, with the kernels' plain torch
                       versions (the tests' path);
  * "host"           - the GMP host backend (ops/hostgmp.py GmpEngine);
                       raises when it does not build.

With `mesh` (parallel/sharded.py) the TorchEngine runs SPMD over the ranks
of a torch.distributed process group. `compact=True` builds no engine: the
compact variant's c1 lives in Cl(Delta_K) and its c2 in Cl(Delta), and no
single-discriminant batch holds both, so every op runs element by element
on the host, as in the JAX package. It is the one path of the port that
does not run on the card.

Ciphertexts and results are bit-identical across devices, and with the JAX
package's CryptoSystem for the same seed (unique reduced forms).
`make_cryptosystem` mirrors the reference factory (cofhe.hpp:96-121).
"""

from __future__ import annotations

from enum import Enum
from typing import Sequence

from . import serialize as ser
from .core import liss
from .core.cl_hsm2k import CLHSM2k, CipherText
from .core.fixedpoint import FixedPointCodec
from .core.qfi import Form
from .core.rng import RandGen
from .tensor import Tensor


class Device(Enum):
    CPU = "cpu"   # the reference's CPU cryptosystem: the GMP host backend
    GPU = "gpu"   # the card: TorchEngine on "cuda"


class Precision(Enum):
    FP32 = "fp32"
    FP64 = "fp64"


class SecurityLevel(Enum):
    LOW = 80
    MEDIUM = 128
    HIGH = 256


class CryptoSystem:
    """CL_HSM2k cryptosystem; batched ops run on `device`."""

    def __init__(self, security_level: int, k: int, compact: bool = False,
                 device: str = "cuda", seed: bytes | None = None,
                 p: int | None = None, mesh=None, rerandomize: str = "none"):
        """rerandomize: fold a fresh Enc(0) into every homomorphic add/scal
        result - "none" (reference default: the macros are compiled out),
        "shared" (one Enc(0) per batched op, the
        ADD_RANDOMNESS_IN_HOMOMORPHIC_OPERATIONS semantics), or "per_op"
        (fresh randomness per element, DIFFERENT_RANDOMNESS_FOR_EACH_
        OPERATION; reference cpu_cryptosystem_vector_ops.inl:1-2,65-92)."""
        if rerandomize not in ("none", "shared", "per_op"):
            raise ValueError("rerandomize must be none|shared|per_op")
        self.hsm2k = CLHSM2k(security_level, k, compact_variant=compact, p=p)
        self.sec_level = security_level
        self.k = k
        self.codec = FixedPointCodec(k)
        self.rand_gen = RandGen(seed)
        self.device = device
        self.rerandomize = rerandomize
        if compact:
            # mixed Cl(Delta_K) / Cl(Delta) forms: element level on the host
            # (the hsm2k routes each group's ops to its own GMP backend)
            self._engine = None
        elif device == "host":
            from .ops.hostgmp import GmpEngine

            self._engine = GmpEngine(self.hsm2k)
        else:
            from .ops.engine import TorchEngine

            self._engine = TorchEngine(self.hsm2k, device=device, mesh=mesh)

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
        return self._rerand(pk, [self.hsm2k.add_ciphertexts(ct1, ct2)])[0]

    def scal_ciphertext(self, pk: Form, s: int, ct: CipherText) -> CipherText:
        if s < 0:
            raise ValueError("plaintext scalar must be non-negative")
        return self._rerand(pk, [self.hsm2k.scal_ciphertext(ct, s)])[0]

    def _rerand(self, pk, cts: list) -> list:
        """Optional Enc(0) folding after homomorphic ops (reference
        ADD_RANDOMNESS_IN_HOMOMORPHIC_OPERATIONS /
        DIFFERENT_RANDOMNESS_FOR_EACH_OPERATION macros,
        cpu_cryptosystem_vector_ops.inl:1-2,65-92)."""
        if self.rerandomize == "none" or pk is None:
            return cts
        if self.rerandomize == "shared":
            zeros = [self.hsm2k.encrypt(pk, 0, self.rand_gen)] * len(cts)
        else:  # per_op: fresh randomness per element
            zeros = [self.hsm2k.encrypt(pk, 0, self.rand_gen) for _ in cts]
        return self._add_batch(cts, zeros)

    def _add_batch(self, cts1, cts2) -> list:
        if self._engine is not None:
            return self._engine.add_batch(list(cts1), list(cts2))
        return [self.hsm2k.add_ciphertexts(a, b) for a, b in zip(cts1, cts2)]

    def negate_ciphertext(self, pk: Form, ct: CipherText) -> CipherText:
        # the reference scales by make_plaintext(-1) = 2^k - 1, a full k-bit
        # nupow (cpu_cryptosystem.inl:95-98); group inversion gives the same
        # decryption (randomness -r instead of r(2^k - 1)) in O(1)
        return self.hsm2k.negate_ciphertext(ct)

    # ------------------------------------------------------------- plaintext
    def generate_random_plaintext(self) -> int:
        return self.rand_gen.random_mpz(self.hsm2k.cleartext_bound())

    def generate_random_beavers_triplet(self) -> list[int]:
        # bound 10 as in the reference (cpu_cryptosystem.inl:36-47)
        a = self.rand_gen.random_mpz(10)
        b = self.rand_gen.random_mpz(10)
        return [a, b, a * b]

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
        if self._engine is not None:
            return self._engine.decrypt_batch(sk, list(cts))
        return [self.hsm2k.decrypt(sk, ct) for ct in cts]

    def part_decrypt_vector(self, sks: int,
                            cts: Sequence[CipherText]) -> list[Form]:
        if self._engine is not None:
            return self._engine.part_decrypt_batch(sks, list(cts))
        return [self.hsm2k.part_decrypt(ct, sks) for ct in cts]

    def combine_part_decryption_results_vector(self, cts,
                                               pdrs_per_party) -> list[int]:
        """pdrs_per_party: list over parties of per-element PDR lists. From
        the engine's minimum batch on, the TorchEngine's batched combine
        tree; below it, on the host engine or without an engine (compact),
        element-level host code."""
        if hasattr(self._engine, "combine_batch") \
                and len(cts) >= self._engine.min_batch_encrypt:
            return self._engine.combine_batch(
                list(cts), [list(p) for p in pdrs_per_party])
        return [self.hsm2k.final_decrypt(ct, [p[i] for p in pdrs_per_party])
                for i, ct in enumerate(cts)]

    def add_ciphertext_vectors(self, pk, ct1, ct2) -> list[CipherText]:
        if len(ct1) != len(ct2):
            raise ValueError("vector sizes must be equal")
        return self._rerand(pk, self._add_batch(ct1, ct2))

    def scal_ciphertext_vector(self, pk, s, cts) -> list[CipherText]:
        if isinstance(s, (list, tuple)):
            if len(s) != len(cts):
                raise ValueError("vector sizes must be equal")
            scalars = [int(x) for x in s]
        else:
            scalars = [int(s)] * len(cts)
        if any(x < 0 for x in scalars):
            raise ValueError("plaintext scalar must be non-negative")
        if self._engine is not None:
            out = self._engine.scal_batch(scalars, list(cts))
        else:
            out = [self.hsm2k.scal_ciphertext(ct, x)
                   for x, ct in zip(scalars, cts)]
        return self._rerand(pk, out)

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

    def add_ciphertext_tensors(self, pk, ct1: Tensor, ct2: Tensor) -> Tensor:
        if ct1.shape != ct2.shape:
            raise ValueError("tensor shapes must be equal")
        return Tensor(self.add_ciphertext_vectors(pk, ct1.data, ct2.data),
                      ct1.shape)

    def scal_ciphertext_tensors(self, pk, s: Tensor, cts: Tensor) -> Tensor:
        """0-D*0-D elementwise, 1-Dx1-D elementwise, or (m,p) x (n,m) -> (n,p)
        homomorphic matmul: res[i,k] = Enc(0) + sum_j s[j,k] * ct[i,j]
        (reference cpu_cryptosystem_tensor_ops.inl:269-462)."""
        if s.ndim > 2 or cts.ndim > 2:
            raise ValueError("tensors must be 0D, 1D or 2D for now")
        if s.is_zero_degree() and cts.is_zero_degree():
            return Tensor.zero_degree(
                self.scal_ciphertext(pk, s.get_value(), cts.get_value()))
        if s.is_zero_degree():
            # 0-D scalar x n-D ct tensor: broadcast elementwise scal (the
            # reference's 0-D tensor is a 1-element storage its accessors
            # broadcast, tensor.hpp:1109; cpu_cryptosystem_tensor_ops.inl:
            # 275-340). Shaped 1-element tensors keep the reference's
            # column-vector / matmul dimension checks (:281-285).
            return Tensor(self.scal_ciphertext_vector(
                pk, [s.data[0]] * len(cts.data), cts.data), cts.shape)
        if cts.is_zero_degree():
            return Tensor(self.scal_ciphertext_vector(
                pk, s.data, [cts.data[0]] * len(s.data)), s.shape)
        if s.ndim == 1 and cts.ndim == 1:
            if s.shape != cts.shape:
                raise ValueError("vector sizes must be equal")
            return Tensor(self.scal_ciphertext_vector(pk, s.data, cts.data),
                          cts.shape)
        if s.ndim != 2 or cts.ndim != 2:
            raise ValueError(f"matmul needs 2-D operands: ct {cts.shape} "
                             f"x s {s.shape}")
        n, m = cts.shape
        m2, p = s.shape
        if m != m2:
            raise ValueError(f"matmul shape mismatch: ct {cts.shape} x s {s.shape}")
        if any(x < 0 for x in s.data):
            raise ValueError("plaintext scalar must be non-negative")
        zero = self.encrypt(pk, 0)
        if self._engine is not None:
            return self._engine.scal_matmul(s, cts, zero)
        return self._scal_matmul_host(s, cts, zero)

    def _scal_matmul_host(self, s: Tensor, cts: Tensor,
                          zero: CipherText) -> Tensor:
        """Element-level matmul (compact mode): each row sum is seeded with
        Enc(0) and accumulates ct[i,j]^s[j,k] in j order."""
        n, m = cts.shape
        _, p = s.shape
        res = []
        for i in range(n):
            for kk in range(p):
                acc = zero
                for j in range(m):
                    acc = self.hsm2k.add_ciphertexts(
                        acc, self.hsm2k.scal_ciphertext(cts.at(i, j), s.at(j, kk)))
                res.append(acc)
        return Tensor(res, (n, p))

    def negate_ciphertext_tensor(self, pk, ct: Tensor) -> Tensor:
        # group inversion per element (see negate_ciphertext)
        return ct.map(self.hsm2k.negate_ciphertext)

    def add_plaintext_tensors(self, pt1: Tensor, pt2: Tensor) -> Tensor:
        if pt1.shape != pt2.shape:
            raise ValueError("tensor shapes must be equal")
        return pt1.zip_map(pt2, lambda a, b: a + b)

    def multiply_plaintext_tensors(self, pt1: Tensor, pt2: Tensor) -> Tensor:
        if pt1.shape != pt2.shape:
            raise ValueError("tensor shapes must be equal")
        return pt1.zip_map(pt2, lambda a, b: a * b)

    def negate_plaintext_tensor(self, pt: Tensor) -> Tensor:
        return pt.map(self.negate_plaintext)

    # exact concept-surface name (cofhe.hpp:50 spells it negate_plain_tensor)
    negate_plain_tensor = negate_plaintext_tensor

    # ----------------------------------------------------------- primitives
    def _encrypt_batch(self, pk: Form, pts: list[int]) -> list[CipherText]:
        """Shared-randomness batch encryption (reference encrypt_vector,
        cpu_cryptosystem_vector_ops.inl:4-18): one r per batch, c1 = h^r and
        pk^r on the host, the per-element c2 = pk^r * f^m composes batched
        on the engine (element-level on the host below its minimum batch
        or without an engine). Compact: pk lives in Cl(Delta_K), so pk^r is
        taken there and lifted once."""
        r = self.rand_gen.random_mpz(self.hsm2k.encrypt_randomness_bound())
        c1 = self.hsm2k.power_of_h(r)
        if self.hsm2k.compact_variant():
            pkr = self.hsm2k._lift_pow(self.hsm2k._nupowK(pk, r))
        else:
            pkr = self.hsm2k.nupow(pk, r)
        if self._engine is not None \
                and len(pts) >= getattr(self._engine, "min_batch_encrypt", 2):
            fms = [self.hsm2k.power_of_f(pt % self.hsm2k.M) for pt in pts]
            c2s = self._engine.compose_forms_batch([pkr] * len(pts), fms)
            return [CipherText(c1, c2) for c2 in c2s]
        return [self.hsm2k.encrypt_with_parts(pt % self.hsm2k.M, c1, pkr)
                for pt in pts]

    # --------------------------------------------------------- serialization
    def serialize(self) -> str:
        return (f"CPUCryptoSystem {self.sec_level} {self.k} "
                f"{int(self.hsm2k.compact_variant())}")

    @staticmethod
    def deserialize(data: str, device: str = "cuda") -> "CryptoSystem":
        parts = data.split()
        return CryptoSystem(int(parts[1]), int(parts[2]),
                            compact=bool(int(parts[3])), device=device)

    serialize_secret_key = staticmethod(ser.serialize_secret_key)
    serialize_secret_key_share = staticmethod(ser.serialize_secret_key_share)
    serialize_public_key = staticmethod(ser.serialize_public_key)
    serialize_plaintext = staticmethod(ser.serialize_plaintext)
    serialize_ciphertext = staticmethod(ser.serialize_ciphertext)
    serialize_part_decryption_result = staticmethod(ser.serialize_pdr)
    serialize_plaintext_tensor = staticmethod(ser.serialize_plaintext_tensor)
    serialize_ciphertext_tensor = staticmethod(ser.serialize_ciphertext_tensor)
    serialize_part_decryption_result_tensor = staticmethod(ser.serialize_pdr_tensor)
    deserialize_secret_key = staticmethod(ser.deserialize_secret_key)
    deserialize_secret_key_share = staticmethod(ser.deserialize_secret_key_share)
    deserialize_public_key = staticmethod(ser.deserialize_public_key)
    deserialize_plaintext = staticmethod(ser.deserialize_plaintext)
    deserialize_ciphertext = staticmethod(ser.deserialize_ciphertext)
    deserialize_part_decryption_result = staticmethod(ser.deserialize_pdr)
    deserialize_plaintext_tensor = staticmethod(ser.deserialize_plaintext_tensor)
    deserialize_ciphertext_tensor = staticmethod(ser.deserialize_ciphertext_tensor)
    deserialize_part_decryption_result_tensor = staticmethod(ser.deserialize_pdr_tensor)


def make_cryptosystem(security_level, k_or_precision=None, depth_or_device=None,
                      device: Device | str = Device.GPU, **kw) -> CryptoSystem:
    """Factory mirroring the three reference overloads (cofhe.hpp:96-121).
    Device.GPU ("gpu") runs on "cuda", Device.CPU ("cpu") on the GMP host
    backend, the reference's CPU cryptosystem; "cuda" and "host" pass
    through."""
    if isinstance(security_level, SecurityLevel):
        sec = security_level.value
    else:
        sec = int(security_level)
    if isinstance(k_or_precision, Precision):
        depth = int(depth_or_device)
        k = depth * (64 if k_or_precision == Precision.FP32 else 128)
    else:
        k = int(k_or_precision)
    dev = device.value if isinstance(device, Device) else str(device)
    backend = {"gpu": "cuda", "cpu": "host"}.get(dev, dev)
    return CryptoSystem(sec, k, device=backend, **kw)
