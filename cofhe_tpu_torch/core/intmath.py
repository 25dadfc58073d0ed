"""Integer number theory helpers (pure Python ints).

This is the L0 ground-truth layer of the TPU framework: everything the
reference delegates to GMP/BICYCL (`reference include/x86_64/*.inl`
call sites into BICYCL::Mpz) is re-implemented here on Python ints and is
used (a) directly by the host/reference compute path and (b) as the
bit-exact oracle for the torch/CUDA limb kernels in cofhe_tpu_torch/ops/.
"""

from __future__ import annotations


def xgcd(a: int, b: int) -> tuple[int, int, int]:
    """Extended gcd. Returns (g, u, v) with u*a + v*b == g, g >= 0."""
    old_r, r = a, b
    old_s, s = 1, 0
    old_t, t = 0, 1
    while r:
        q = old_r // r
        old_r, r = r, old_r - q * r
        old_s, s = s, old_s - q * s
        old_t, t = t, old_t - q * t
    if old_r < 0:
        old_r, old_s, old_t = -old_r, -old_s, -old_t
    return old_r, old_s, old_t


def invmod(a: int, m: int) -> int:
    """Inverse of a modulo m. Raises ValueError if not invertible."""
    g, u, _ = xgcd(a % m, m)
    if g != 1:
        raise ValueError(f"not invertible: gcd={g}")
    return u % m


def isqrt(n: int) -> int:
    import math

    return math.isqrt(n)


def jacobi(a: int, n: int) -> int:
    """Jacobi symbol (a/n); n must be positive odd."""
    if n <= 0 or n % 2 == 0:
        raise ValueError("n must be positive odd")
    a %= n
    result = 1
    while a != 0:
        while a % 2 == 0:
            a //= 2
            if n % 8 in (3, 5):
                result = -result
        a, n = n, a
        if a % 4 == 3 and n % 4 == 3:
            result = -result
        a %= n
    return result if n == 1 else 0


_SMALL_PRIMES = [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61, 67, 71, 73, 79, 83, 89, 97]


def is_prime(n: int) -> bool:
    """Deterministic-for-our-sizes Miller-Rabin (plus BPSW-ish extra rounds)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    # fixed witness set + a few pseudo-random witnesses derived from n
    witnesses = list(_SMALL_PRIMES[:20])
    x0 = n
    for _ in range(8):
        x0 = (x0 * 6364136223846793005 + 1442695040888963407) % (2**64)
        witnesses.append(2 + x0 % (n - 3) if n > 5 else 2)
    for a in witnesses:
        a %= n
        if a < 2:
            continue
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def next_prime(n: int) -> int:
    n += 1
    if n <= 2:
        return 2
    if n % 2 == 0:
        n += 1
    while not is_prime(n):
        n += 2
    return n


def gcd(a: int, b: int) -> int:
    import math

    return math.gcd(a, b)


def kronecker(a: int, n: int) -> int:
    """Kronecker symbol (a/n) for any integers."""
    if n == 0:
        return 1 if a in (1, -1) else 0
    if n < 0:
        return (-1 if a < 0 else 1) * kronecker(a, -n)
    # n > 0
    v = 0
    while n % 2 == 0:
        n //= 2
        v += 1
    if v % 2 == 0:
        r = 1
    else:
        am8 = a % 8
        if am8 in (1, 7):
            r = 1
        elif am8 in (3, 5):
            r = -1
        else:
            return 0  # a even
    if n == 1:
        return r
    return r * jacobi(a, n)


def bit_length(n: int) -> int:
    return abs(n).bit_length()


def extract_bits(n: int, j: int, w: int) -> int:
    """BICYCL Mpz::extract_bits semantics (see reference qfi.inl:75): the w
    bits of |n| ending at bit index j (i.e. bits [j-w+1 .. j], MSB first),
    where bits below 0 read as 0."""
    n = abs(n)
    lo = j - w + 1
    if lo >= 0:
        return (n >> lo) & ((1 << w) - 1)
    # shift left for negative lo
    return (n << -lo) & ((1 << w) - 1)


def ceil_div(a: int, b: int) -> int:
    return -((-a) // b)


def ceil_abs_div(a: int, b: int) -> int:
    """Round |a|/|b| toward +inf."""
    return ceil_div(abs(a), abs(b))


def mod_sym(a: int, m: int) -> int:
    """Symmetric remainder in (-m/2, m/2]."""
    r = a % m
    if 2 * r > m:
        r -= m
    return r
