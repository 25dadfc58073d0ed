"""CL_HSM2k: threshold-friendly linearly homomorphic encryption over class
groups of imaginary quadratic orders, with message space Z/2^k Z.

Re-derivation (from scratch, verified empirically and by group theory) of the
scheme the reference obtains from BICYCL (`BICYCL::CL_HSM2k`, used throughout
reference include/x86_64/*.inl; the scheme is from Castagnos-
Laguillaumie-Tucker, eprint 2022/1143, cited at
cpu_cryptosystem_distributed.inl:174,247,260).

Construction
------------
* p: deterministic odd prime with p_bits = max(disc_bits(sec) - 3, 2k + 16).
* Fundamental discriminant DeltaK = -8p  (always fundamental for odd p).
* Working order: conductor 2^(k+1), Delta = 2^(2k+2) * DeltaK.
* F = <f> with  f = (2^(2k), 2^(k+1), 1 - DeltaK)  is cyclic of order 2^k
  (kernel of Cl(Delta) -> Cl(DeltaK) is cyclic of order 2^(k+1); F is its
  subgroup of squares).
* In the "large DeltaK" regime |DeltaK| >~ 4^k (enforced by p_bits above),
  every element of F has the unique reduced form
      f^(2^v * m') = (4^j, 2^(j+1) * L, L^2 - 4^v * DeltaK),   j = k - v,
  with L odd, |L| < 2^(j-1).
* dlog_in_F is CLOSED FORM via the 2-adic formal logarithm of the kernel's
  formal group law  t (+) s = (t + s) / (1 - 2 p t s):
      lambda(t) = sum_i (-1)^i (2p)^i t^(2i+1) / (2i+1)   (arctan-type)
  with parameter t = -2^(v+1) * L^(-1) (2-adically);  m = lambda(t)/lambda(t_f)
  mod 2^k where t_f = -2 is f's parameter. Conversely power_of_f(m) is O(1)
  via Newton inversion of lambda (formal exponential).
* Encrypt(pk, m; r) = (h^r, f^m * pk^r);  h = lift(prime form)^(2^(k+1)).
* Threshold decryption via LISS shares (see liss.py) : di = c1^si and
  d = prod di^lambda_i, m = dlog_in_F(c2 * d^-1).

All arithmetic here is pure Python int; this module is the bit-exact oracle
for the batched torch kernels in cofhe_tpu_torch/ops/ (a copy of the JAX
package's module, kept so the port never imports that package).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from .intmath import invmod, is_prime, isqrt, kronecker
from .qfi import (
    Form,
    compose,
    form_from_ab,
    identity_form,
    lift_form,
    neg,
    nudupl,
    nupow,
    prime_form,
    reduce_form,
)
from .rng import RandGen

# |DeltaK| size (bits) per security level — class-group discriminant sizes
# (matching BICYCL's SecLevel table; 80 is an extrapolation for CoFHE's LOW).
DISC_BITS = {80: 1012, 112: 1348, 128: 1827, 192: 3598, 256: 5971}

DEFAULT_STAT_DISTANCE = 40  # statistical-distance parameter for randomness bounds


@dataclass(frozen=True)
class CipherText:
    c1: Form
    c2: Form

    def __iter__(self):
        return iter((self.c1, self.c2))


# Pre-derived deterministic primes for standard (security_level, k) pairs
# (identical to what _derive_p produces; cached to skip minutes of prime
# search at startup). Keys: (security_level, k).
_PRECOMPUTED_P = {
    (112, 128): int(
        "0x16416c441245e196415d79189aab1c44191fa28854a77d436ab3f2130a766aa91985d16bf7175aea1e9c1ac85bf48ffaafd2a1c9265b1180ee3caad7cd9fbe32a0674d7646866ee2b8ea82507fba5d1d1441e7cb771d37c7ac6cdae96f6157801cde3fcf2c599a704f2b82f7d0bc739c0789ae1b192efc06028fdcd4ce25cd920aca9d5f12b4d41e886137992b2abb1b7afc2fc623fad062525b026f297502cde5f0b49a9a6adf229", 16),
    (112, 256): int(
        "0x165a26871e09462a6b5a44e0bb6e4fdbe5f46b2496bd32e293d45f92cc7c7f7a8cf41508fdf5932fed05c7abb4f2c2da07f5b7c9910afb396e3ce297720ce00d4279ed41adac2db4cf2951ccd2411cd818a3ee9a0de70695482cdb94c089974384be3328f3d50e4673b10d541b4c93011230be93bd0dd41e46a109776ef12dc6ed2cd8ec9a4ed8131de766aba36a03016280c2c7f6fbdcdbcb1f8ee7c078416419c415e15521423b9", 16),
    (112, 64): int(
        "0x1568b247639fec4f2d30b0c6ce2f15763236139cfd24c28ee21255a93a56a22f24764bde13589d4d78fa233575c235140e79d1941de0e90a4d484ed94489bfc9781e651b6d623c13e1c9446d7b225a804fcb3d746fd3accc292e1066813396f051018e4cb1d1615dfde0eb76fee97fc1b47d85c8a4fa4b1b97980b37bf0da4ca79fb0c06f96193f113702a3e9bff35c6c89bf02a609572255596ee9523ef32a3374413cd99fb90d61", 16),
    (128, 128): int(
        "0xdc28aea0306171978a8245a9aa8e980e2d8670356bb26e6467acb86d2b1a8cd4c21ae98573ae90ba57e72b2add22d99a485d8d6e17d57c71a88ca8873e1a1dbc208b65ccd73915ded92cd3db7bea37767b75d4128ca20ab10e6d369e74d0d0f46492d30bba9e7e860b88f8062c4138724c8a14b3cde3d20638a2c1f931b2341319adcf2b66f1010475e1fb6d1be319f834f20c64d5ad4366b4738ef0bb302eb891faae1da7c2b1fdd1f036b282f6a537b3f8cb21133c45e6045c4f7531ffc7aedfc1bed5c9f60286d4f26101209de7661275307e2efb6b0b209208b66ed52a8b8e4b9695", 16),
    (128, 256): int(
        "0xf92e78bf53c462fd3c7d065aaa8017b89aa5617d95eebccd89643f05099b0be94f50febd28b359759b59f9199064f7e7b7e096cf6c434b9d2df1e335e9e2d0ac7ab3b3fcbb6a44fb3ccfc042456f685102e20c58f105b01b2a7227af87639e8ba680832ba661bfd585414bfcc30f30de8c61ed2a69978f8f8033ba9f0a86a10d4a0793761031946bf698b9f358de4db54c70b885776c538e94f26cc5ea4c40117fefbcd2bba57ccb6c6e9959cb387b53ff7c7c361110691a1098e350aebd1d8fbc772e0cc63aab2089d072a82a62b547a29a6ffffbd7ae2aa07c12543423814815536117", 16),
    (128, 32): int(
        "0xa7f5fc92a3257692cae45ae0c3bdbc3b181fc133bb5c56c00d31d72a66b4cd91d32e3592b9c3c7c874a4a908e69072576a501cd8e078fe3395a0b155b8b42002db0afa8c005dc8d3052af07978d3866d31d6c58d65e75fbde7ced500304db17667f491683ac4a346f68f5c8bd26e8045a350ff3ffc73d994c5f2d7ce8f7af964d30c74c0bf6f2a68b91eee237f306dce39f6b3b0815ef04c4b4bc5b224deba27c204484d44ca45e56f5c98695ed77823f932edf8698a6f66c56f044f30135030b304b833cf75ab17b4daaed619a7d77d07646523f3f407fb2e94364fd26329271571086b", 16),
    (128, 64): int(
        "0x94e1a897e649d2c4925b8447abe6a301802dde153f2b774333de903449897aa7d03da24108eb2bcdef3c4d7cafe2366aec6c1632e18121ff237139a9c5f8b46a49ed5c9fe80e50e1a7b1d30f61a1d35581e8d4309591feed5dbfa71612d59c2069e953c897cfb7aa41e271a1d873afc42236f82f07f889647e08698dad7920c19b9f91494953fee355e5b2cd4c6b54d50bcdf329119c21aa13315146d1d93d070d6080c09c0e829f48f45cb13ceabe27bb60ddbbf30a93ed4f0f8f577808c15130e089b1ed656eaf8eae448b2aa22fc79475f90eee23f98da39fa34e2ba9b2b15ceb16d3", 16),
    (80, 128): int(
        "0x12bfeadeed1f0dedff5462133b1771f9e4285da2dff3ac65633063cf6eefc9646cf5201f465b9f302d94dc318b93ad8ce0086b7994f071766170a560d6fa9ba36dffbc637f4871bf10a3af95db5b8f195357f822ab31efa741853ee1a5c532da768691ad0aff7b9331d08d8a4b14666f616ba1d35793ebb856d9e45a04ddf", 16),
    (80, 256): int(
        "0x1a0c43d57721447578fcb0ebdd27e1a2275c840bb51ec759762b10a74edb2e954da9bc865e17d30786f58cd5449a0d47cf3db29b7b2313fc64be8d77750ba3a182bc0121fdd76343288f1a1d18aa34495109d1b03a0327c51314ef8dbc5478ab45d067b4667813a8f76a7d287c170f32383df7e5472bdf6fbdcb8069e75d3", 16),
    (80, 32): int(
        "0x117e0ace4d052f117ea4e9f9e0368faa02cc8e4432b3a0e1f286aecdf3b3b62c8417dac4640a644729f426df844535d6c07bd2686ada79d68c2eed0c9b0cc612db304e41c50b39a665e4b2b33b332e95de2fab4c1d181dcdf9824c73d9110070e81af66627fe0e401eb718f7ba06571571533c2f8eb0f30fce1246ed0c9e3", 16),
    (80, 64): int(
        "0x1e768bc86c1a3de1f129dde13297ed11354a7b8a7435e1824e1025f2b10d65b0786b366d5fa28559ff7ca9fe94cb58c2be9f6bd45e8ef89ce2e7c69668b6f0a33af2e35fa6a0294c6b090736bd7b481a95406c47db4901bfd358b69ba521e4c0ebf55b253f4b56b4d8afabdc13a342721b884eaeef61adc5859f67c0422d9", 16),
}


def _derive_p(security_level: int, k: int) -> int:
    """Deterministic prime p for DeltaK = -8p, derived from (sec, k) only."""
    if security_level not in DISC_BITS:
        raise ValueError(f"unsupported security level {security_level}")
    p_bits = max(DISC_BITS[security_level] - 3, 2 * k + 16)
    rng = RandGen(f"cofhe-tpu-params-v1:{security_level}:{k}".encode())
    while True:
        cand = rng.random_bits(p_bits) | (1 << (p_bits - 1)) | 1
        if is_prime(cand):
            return cand


@lru_cache(maxsize=16)
def _cached_params(security_level: int, k: int) -> int:
    import os

    override = os.environ.get("COFHE_P_OVERRIDE")
    if override:
        # test hook: tiny toy prime shared by every process of a local
        # network (production nodes derive p deterministically from sec/k)
        return int(override, 16)
    if (security_level, k) in _PRECOMPUTED_P:
        return _PRECOMPUTED_P[(security_level, k)]
    return _derive_p(security_level, k)


class CLHSM2k:
    def __init__(self, security_level: int, k: int, compact_variant: bool = False,
                 p: int | None = None, distance: int = DEFAULT_STAT_DISTANCE):
        self.security_level = security_level
        self.k = k
        # Compact variant (reference cofhe.hpp:96-121 concept arm; lift at
        # cpu_cryptosystem_vector_ops.inl:11-13): h, pk and c1 live in the
        # SMALLER group Cl(DeltaK) (coefficients ~|DeltaK| instead of
        # ~|Delta| bits — less bandwidth, cheaper c1 exponentiations) and
        # are lifted on use:  x -> lift(x)^(2^(k+1)).  The 2^(k+1) power
        # annihilates the lift's kernel ambiguity (the kernel of
        # Cl(Delta) -> Cl(DeltaK) has order 2^(k+1)), so
        # lift(x^n)^(2^(k+1)) = [lift(x)^(2^(k+1))]^n exactly, which is all
        # encrypt/decrypt need.
        self._compact = bool(compact_variant)
        self.distance = distance
        self.p = p if p is not None else _cached_params(security_level, k)
        self.DeltaK = -8 * self.p
        self.cond = 1 << (k + 1)
        self.Delta = self.cond * self.cond * self.DeltaK
        self.M = 1 << k  # cleartext bound 2^k
        # generator of F (order 2^k) — closed form, see module docstring
        self.f = Form(1 << (2 * k), 1 << (k + 1), 1 - self.DeltaK)
        self.identity = identity_form(self.Delta)
        # randomness / secret-key bound: covers |Cl(Delta)| ~ h(DeltaK)*2^(k+1)
        # with 2^distance statistical slack; h(DeltaK) < sqrt(|DeltaK|)*log(..)
        class_number_bound = (isqrt(-self.DeltaK) + 1) * self.DeltaK.bit_length()
        self._rand_bound = class_number_bound * (1 << (k + 1)) << distance
        if self._compact:
            self.identityK = identity_form(self.DeltaK)
            self.hK = self._derive_hK()   # generator kept in Cl(DeltaK)
            self.h = self._lift_pow(self.hK)
        else:
            self.h = self._derive_h()
        # cached odd-inverse of lambda(t_f)/2 (t_f = -2), used by dlog/power_of_f
        N = self.k + 3
        den = self._formal_log(-2 % (1 << N), N)
        assert den % 2 == 0 and (den >> 1) % 2 == 1
        self._log_tf_half = den >> 1
        self._inv_log_tf_half = invmod(self._log_tf_half, 1 << (k + 2))

    # -- public parameter accessors (BICYCL CL_HSM2k API parity) -----------
    def encrypt_randomness_bound(self) -> int:
        return self._rand_bound

    def secretkey_bound(self) -> int:
        return self._rand_bound

    def cleartext_bound(self) -> int:
        return self.M

    def compact_variant(self) -> bool:
        return self._compact

    def _derive_hK(self) -> Form:
        """Smallest split odd prime form of DeltaK (deterministic given p)."""
        l = 3
        while True:
            if is_prime(l) and kronecker(self.DeltaK, l) == 1:
                fl = prime_form(self.DeltaK, l)
                if fl is not None:
                    return fl
            l += 2

    def _derive_h(self) -> Form:
        """h = (lift of smallest split odd prime form of DeltaK)^(2^(k+1)).

        Deterministic given p. The 2^(k+1)-th power kills the kernel
        component, so <h> intersects F trivially (required for IND-CPA per
        the CL framework)."""
        fl = self._derive_hK()
        t = lift_form(fl, self.DeltaK, self.cond)
        h = t
        for _ in range(self.k + 1):
            h = nudupl(h)
        return h

    # -- compact-variant helpers (Cl(DeltaK) arithmetic + lift-on-use) ------
    def _composeK(self, f1: Form, f2: Form) -> Form:
        cgK = self._nativeK
        if cgK is not None:
            return cgK.compose_batch([f1], [f2])[0]
        return compose(f1, f2)

    def _nupowK(self, f: Form, n: int) -> Form:
        cgK = self._nativeK
        if cgK is not None:
            return cgK.nupow_batch([f], [n])[0]
        return nupow(f, n)

    @property
    def _nativeK(self):
        if not hasattr(self, "_nativeK_cg"):
            import os

            self._nativeK_cg = None
            if not os.environ.get("COFHE_PURE_PYTHON"):
                try:
                    from ..ops.hostgmp import GmpClassGroup

                    self._nativeK_cg = GmpClassGroup(self.DeltaK)
                except Exception:
                    pass
        return self._nativeK_cg

    @staticmethod
    def _odd_a_rep(f: Form) -> Form:
        """Equivalent form with `a` coprime to the (2-power) conductor."""
        if f.a & 1:
            return f
        if f.c & 1:
            return Form(f.c, -f.b, f.a)
        # primitive with a, c even: a+b+c is odd
        return Form(f.a + f.b + f.c, f.b + 2 * f.c, f.c)

    def _lift_pow(self, fK: Form) -> Form:
        """lift(fK)^(2^(k+1)): Cl(DeltaK) -> Cl(Delta), kernel-free."""
        t = lift_form(self._odd_a_rep(fK), self.DeltaK, self.cond)
        for _ in range(self.k + 1):
            t = self._compose(t, t)
        return t

    # -- formal group law helpers (2-adic) ---------------------------------
    def _formal_log(self, t: int, N: int) -> int:
        """lambda(t) = sum (-1)^i (2p)^i t^(2i+1)/(2i+1) mod 2^N, t even."""
        mod = 1 << N
        ratio = (-2 * self.p) % mod
        t2 = t * t % mod
        acc = 0
        cur = t % mod
        i = 0
        while cur != 0:
            acc = (acc + cur * invmod(2 * i + 1, mod)) % mod
            cur = cur * ratio % mod * t2 % mod
            i += 1
        return acc

    def _formal_exp(self, u: int, N: int) -> int:
        """Inverse of _formal_log mod 2^N via Newton iteration (u even)."""
        mod = 1 << N
        u %= mod
        t = u % 8  # initial approx: lambda(t) = t + O(t^3 * 2p), correct mod 8
        prec = 3
        while prec < N:
            prec = min(2 * prec, N)
            m2 = 1 << prec
            # t <- t - (lambda(t) - u) * (1 + 2p t^2) mod 2^prec
            lam = self._formal_log(t % m2, prec)
            deriv_inv = (1 + 2 * self.p * t * t) % m2  # 1/lambda'(t)
            t = (t - (lam - u) * deriv_inv) % m2
        return t % mod

    # -- F subgroup: fast power and dlog -----------------------------------
    def power_of_f(self, m: int) -> Form:
        """f^m in O(1) big-int ops via the formal exponential."""
        m %= self.M
        if m == 0:
            return self.identity
        v = (m & -m).bit_length() - 1
        j = self.k - v
        N = self.k + 3
        mod = 1 << N
        u = m * ((self._log_tf_half << 1) % mod) % mod
        t = self._formal_exp(u, N)
        # t = -2^(v+1) / L  =>  L = -2^(v+1) * inv(t >> (v+1)) * ... (odd part)
        assert t % (1 << (v + 1)) == 0 and (t >> (v + 1)) % 2 == 1, (m, v, t)
        Linv = -(t >> (v + 1)) % (1 << j)  # L^{-1} mod 2^j (odd)
        L = invmod(Linv, 1 << j)
        # symmetric representative
        if L >= (1 << (j - 1)):
            L -= 1 << j
        a = 1 << (2 * j)
        b = L << (j + 1)
        c = L * L - (1 << (2 * v)) * self.DeltaK
        r = Form(a, b, c)
        assert r.disc == self.Delta
        return r

    def dlog_in_F(self, r: Form) -> int:
        """Closed-form discrete log in F (the decrypt finisher; reference
        calls BICYCL's dlog_in_F at cpu_cryptosystem_distributed.inl:269)."""
        if r == self.identity:
            return 0
        a, b, _c = r
        j = (a.bit_length() - 1) // 2
        if a != 1 << (2 * j) or j > self.k:
            raise ValueError("form is not in F (invalid ciphertext/decrypt)")
        L = b >> (j + 1)
        if L << (j + 1) != b or L % 2 == 0:
            raise ValueError("form is not in F")
        v = self.k - j
        N = self.k + 3
        mod = 1 << N
        t = (-(1 << (v + 1)) * invmod(L, mod)) % mod
        num = self._formal_log(t, N)
        m = ((num >> 1) * self._inv_log_tf_half) % (1 << (self.k + 1))
        return m % self.M

    # -- group ops ----------------------------------------------------------
    # Element-level ops delegate to the native GMP backend when it builds
    # (bit-exact with the pure-Python oracle, tests/test_hostgmp.py);
    # COFHE_PURE_PYTHON=1 forces the oracle path.
    @property
    def _native(self):
        if not hasattr(self, "_native_cg"):
            import os

            self._native_cg = None
            if not os.environ.get("COFHE_PURE_PYTHON"):
                try:
                    from ..ops.hostgmp import GmpClassGroup

                    self._native_cg = GmpClassGroup(self.Delta)
                except Exception:
                    pass
        return self._native_cg

    def _compose(self, f1: Form, f2: Form) -> Form:
        cg = self._native
        if cg is not None:
            return cg.compose_batch([f1], [f2])[0]
        return compose(f1, f2)

    def _nupow(self, f: Form, n: int) -> Form:
        cg = self._native
        if cg is not None:
            return cg.nupow_batch([f], [n])[0]
        return nupow(f, n)

    def nucomp(self, f1: Form, f2: Form) -> Form:
        return self._compose(f1, f2)

    def nucompinv(self, f1: Form, f2: Form) -> Form:
        """f1 * f2^-1 (reference: Cl_Delta().nucompinv at
        cpu_cryptosystem_distributed.inl:267)."""
        return self._compose(f1, neg(f2))

    def nupow(self, f: Form, n: int) -> Form:
        return self._nupow(f, n)

    def power_of_h(self, r: int) -> Form:
        # compact: exponentiate in the small group (c1 stays compact)
        if self._compact:
            return self._nupowK(self.hK, r)
        return self._nupow(self.h, r)

    # -- scheme -------------------------------------------------------------
    def keygen(self, rand_gen: RandGen) -> int:
        return rand_gen.random_mpz(self.secretkey_bound())

    def pk_from_sk(self, sk: int) -> Form:
        if self._compact:
            return self._nupowK(self.hK, sk)
        return self._nupow(self.h, sk)

    def encrypt(self, pk: Form, m: int, rand_gen: RandGen) -> CipherText:
        r = rand_gen.random_mpz(self.encrypt_randomness_bound())
        return self.encrypt_with_r(pk, m, r)

    def encrypt_with_r(self, pk: Form, m: int, r: int) -> CipherText:
        if self._compact:
            # c1 compact; c2 needs pk^r in Cl(Delta):
            #   lift(pkK^r)^(2^(k+1)) = [lift(pkK)^(2^(k+1))]^r
            c1 = self._nupowK(self.hK, r)
            pkr = self._lift_pow(self._nupowK(pk, r))
            return CipherText(c1, self._compose(self.power_of_f(m), pkr))
        c1 = self._nupow(self.h, r)
        pkr = self._nupow(pk, r)
        return CipherText(c1, self._compose(self.power_of_f(m), pkr))

    def encrypt_with_parts(self, m: int, c1: Form, pkr: Form) -> CipherText:
        """Shared-randomness batch encryption: c1 = h^r and pkr = pk^r are
        computed once per batch (reference encrypt_vector trick,
        cpu_cryptosystem_vector_ops.inl:4-18). In compact mode pkr must
        already be the LIFTED pk^r (see encrypt_with_r)."""
        return CipherText(c1, self._compose(self.power_of_f(m), pkr))

    def decrypt(self, sk: int, ct: CipherText) -> int:
        if self._compact:
            c1sk = self._lift_pow(self._nupowK(ct.c1, sk))
        else:
            c1sk = self._nupow(ct.c1, sk)
        fm = self._compose(ct.c2, neg(c1sk))
        return self.dlog_in_F(fm)

    def add_ciphertexts(self, ct1: CipherText, ct2: CipherText) -> CipherText:
        if self._compact:
            return CipherText(self._composeK(ct1.c1, ct2.c1),
                              self._compose(ct1.c2, ct2.c2))
        return CipherText(self._compose(ct1.c1, ct2.c1), self._compose(ct1.c2, ct2.c2))

    def scal_ciphertext(self, ct: CipherText, s: int) -> CipherText:
        if s < 0:
            raise ValueError("plaintext scalar must be non-negative")
        if self._compact:
            return CipherText(self._nupowK(ct.c1, s), self._nupow(ct.c2, s))
        return CipherText(self._nupow(ct.c1, s), self._nupow(ct.c2, s))

    def negate_ciphertext(self, ct: CipherText) -> CipherText:
        return CipherText(reduce_form(neg(ct.c1)), reduce_form(neg(ct.c2)))

    # -- threshold ----------------------------------------------------------
    def part_decrypt(self, ct: CipherText, sk_share: int) -> Form:
        """d_i = c1^{s_i} (reference partDecrypt,
        cpu_cryptosystem_distributed.inl:244-254). Compact: the partial
        decryption result is lifted to Cl(Delta) so combination is
        variant-agnostic (the lift commutes with the share sum under the
        2^(k+1) power)."""
        if self._compact:
            return self._lift_pow(self._nupowK(ct.c1, sk_share))
        return self._nupow(ct.c1, sk_share)

    def final_decrypt(self, ct: CipherText, ds: list[Form]) -> int:
        """Combine partial decryptions: lambda = (1, -1, ..., -1),
        d = prod d_i^{lambda_i}, m = dlog_in_F(c2 * d^-1) (reference
        finalDecrypt, cpu_cryptosystem_distributed.inl:256-270)."""
        d = ds[0]
        for di in ds[1:]:
            d = self._compose(d, neg(di))
        fm = self._compose(ct.c2, neg(d))
        return self.dlog_in_F(fm)
