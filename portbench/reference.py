"""Plain reference of the CL_HSM2k arithmetic the cells check, in Python
integers only: binary quadratic forms (a, b, c) of one negative
discriminant, composition with full reduction, powers, the subgroup F of
order 2^k with its closed-form power and discrete log.

It imports nothing of the program (and neither JAX nor the JAX package):
the formulas follow the scheme's description (Castagnos-Laguillaumie with
a 2^k message space; forms reduced to the unique representative |b| <= a
<= c, b >= 0 when |b| == a or a == c), so reduced forms compare exactly.
`CLGroup` holds the parameters of one configuration, from the prime p and
k alone: DeltaK = -8p, Delta = 2^(2k+2) DeltaK, f = (2^2k, 2^(k+1), 1 -
DeltaK), the secret-key bound.
"""

from __future__ import annotations

import math

STAT_DISTANCE = 40  # statistical slack of the key and randomness bounds


def xgcd(a: int, b: int) -> tuple[int, int, int]:
    """(g, u, v) with u a + v b = g >= 0."""
    r0, r1, s0, s1, t0, t1 = a, b, 1, 0, 0, 1
    while r1:
        q = r0 // r1
        r0, r1 = r1, r0 - q * r1
        s0, s1 = s1, s0 - q * s1
        t0, t1 = t1, t0 - q * t1
    if r0 < 0:
        r0, s0, t0 = -r0, -s0, -t0
    return r0, s0, t0


def reduce(a: int, b: int, c: int) -> tuple[int, int, int]:
    """The reduced form equivalent to the positive definite (a, b, c)."""
    D = b * b - 4 * a * c
    r = b % (2 * a)
    if r > a:
        r -= 2 * a
    if r != b:
        b, c = r, (r * r - D) // (4 * a)
    while a > c or (a == c and b < 0):
        a, b = c, -b
        r = b % (2 * a)
        if r > a:
            r -= 2 * a
        b = r
        c = (b * b - D) // (4 * a)
    return a, b, c


def compose(f1, f2):
    """Reduced f1 * f2 (Gauss composition; both of one discriminant)."""
    a1, b1, c1 = f1
    a2, b2, _ = f2
    D = b1 * b1 - 4 * a1 * c1
    s = (b1 + b2) // 2
    if math.gcd(a1, a2) == 1:
        u = pow(a1, -1, a2)
        g, u, v, w = 1, u, (1 - u * a1) // a2, 0
    else:
        g0, u0, v0 = xgcd(a1, a2)
        g, x, w = xgcd(g0, s)
        u, v = x * u0, x * v0
    a3 = a1 * a2 // (g * g)
    num = u * a1 * b2 + v * a2 * b1 + w * ((b1 * b2 + D) // 2)
    if num % g:
        raise ArithmeticError("composition: numerator not divisible by g")
    b3 = (num // g) % (2 * a3)
    return reduce(a3, b3, (b3 * b3 - D) // (4 * a3))


def neg(f):
    """Inverse class, kept reduced (boundary forms are their own inverse)."""
    a, b, c = f
    return (a, b, c) if b == a or a == c else (a, -b, c)


def identity(D: int):
    b = D & 1
    return (1, b, (b * b - D) // 4)


def power(f, n: int):
    """f^n for n >= 0 by a 4-bit sliding window, left to right."""
    a, b, c = f
    D = b * b - 4 * a * c
    if n == 0:
        return identity(D)
    f = reduce(a, b, c)
    sq = compose(f, f)
    tab = [f]
    for _ in range(7):
        tab.append(compose(tab[-1], sq))  # tab[i] = f^(2i+1)
    r = None
    j = n.bit_length() - 1
    while j >= 0:
        if not (n >> j) & 1:
            r = compose(r, r)
            j -= 1
            continue
        lo = max(j - 3, 0)
        while not (n >> lo) & 1:
            lo += 1
        digit = (n >> lo) & ((1 << (j - lo + 1)) - 1)
        if r is None:
            r = tab[digit >> 1]
        else:
            for _ in range(j - lo + 1):
                r = compose(r, r)
            r = compose(r, tab[digit >> 1])
        j = lo - 1
    return r


class FixedBase:
    """Powers of one form by exponents below 2^bits from a table of
    f^(d 2^(w i)), d < 2^w (a fixed-base comb): one composition a nonzero
    digit, so many powers of one base share the table's squarings."""

    def __init__(self, f, bits: int, w: int = 5):
        self.w, self.rows = w, []
        x = reduce(*f)
        for _ in range(-(-bits // w)):
            row = [x]
            for _ in range((1 << w) - 2):
                row.append(compose(row[-1], x))
            self.rows.append(row)  # row[d - 1] = x^d
            x = compose(row[-1], x)  # x^(2^w)
        a, b, c = x
        self.one = identity(b * b - 4 * a * c)

    def power(self, n: int):
        if n < 0 or n >> (self.w * len(self.rows)):
            raise ValueError("exponent outside the table")
        r, mask = None, (1 << self.w) - 1
        for i, row in enumerate(self.rows):
            d = (n >> (self.w * i)) & mask
            if d:
                r = row[d - 1] if r is None else compose(r, row[d - 1])
        return self.one if r is None else r


def powers(form, exps) -> list:
    """[form^e for e in exps], from one fixed-base table."""
    table = FixedBase(form, max(exps, default=0).bit_length() or 1)
    return [table.power(e) for e in exps]


def powers_in_parallel(jobs, workers: int = 4) -> list:
    """[powers(form, exps) for form, exps in jobs], the jobs spread over up
    to `workers` spawned processes (pure Python: threads would share one
    interpreter lock). Every process has ended when this returns."""
    if workers <= 1 or len(jobs) <= 1:
        return [powers(*job) for job in jobs]
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(min(workers, len(jobs)))
    try:
        return pool.starmap(powers, jobs)
    finally:
        pool.close()
        pool.join()


class CLGroup:
    """Cl(Delta) of one configuration, with F = <f> of order 2^k."""

    def __init__(self, p: int, k: int):
        self.p, self.k = p, k
        self.DeltaK = -8 * p
        self.Delta = (1 << (2 * k + 2)) * self.DeltaK
        self.M = 1 << k
        self.identity = identity(self.Delta)
        cnb = (math.isqrt(-self.DeltaK) + 1) * self.DeltaK.bit_length()
        self.secretkey_bound = cnb * (1 << (k + 1)) << STAT_DISTANCE
        N = k + 3
        den = self._log(-2 % (1 << N), N)
        self._log_tf_half = den >> 1
        self._inv_log_tf_half = pow(self._log_tf_half, -1, 1 << (k + 2))

    def _log(self, t: int, N: int) -> int:
        """2-adic logarithm of the formal group at an even t, mod 2^N."""
        mod = 1 << N
        ratio = (-2 * self.p) % mod
        t2 = t * t % mod
        acc, cur, i = 0, t % mod, 0
        while cur:
            acc = (acc + cur * pow(2 * i + 1, -1, mod)) % mod
            cur = cur * ratio % mod * t2 % mod
            i += 1
        return acc

    def _exp(self, u: int, N: int) -> int:
        """Inverse of _log mod 2^N by Newton steps."""
        u %= 1 << N
        t, prec = u % 8, 3
        while prec < N:
            prec = min(2 * prec, N)
            m2 = 1 << prec
            t = (t - (self._log(t % m2, prec) - u) * (1 + 2 * self.p * t * t)) % m2
        return t

    def power_of_f(self, m: int):
        """f^m in closed form."""
        m %= self.M
        if m == 0:
            return self.identity
        v = (m & -m).bit_length() - 1
        j, N = self.k - v, self.k + 3
        t = self._exp(m * ((self._log_tf_half << 1) % (1 << N)), N)
        L = pow(-(t >> (v + 1)) % (1 << j), -1, 1 << j)
        if L >= 1 << (j - 1):
            L -= 1 << j
        return (1 << (2 * j), L << (j + 1), L * L - (1 << (2 * v)) * self.DeltaK)

    def dlog(self, r) -> int:
        """m with f^m = r; ValueError when r lies outside F."""
        if tuple(r) == self.identity:
            return 0
        a, b, _ = r
        j = (a.bit_length() - 1) // 2
        if a != 1 << (2 * j) or j > self.k:
            raise ValueError("form outside F")
        L = b >> (j + 1)
        if L << (j + 1) != b or L % 2 == 0:
            raise ValueError("form outside F")
        N = self.k + 3
        t = (-(1 << (self.k - j + 1)) * pow(L, -1, 1 << N)) % (1 << N)
        num = self._log(t, N)
        return ((num >> 1) * self._inv_log_tf_half) % (1 << (self.k + 1)) % self.M
