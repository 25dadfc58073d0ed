"""Binary quadratic forms over imaginary quadratic orders (pure Python).

Ground-truth implementation of the class-group arithmetic that the reference
outsources to BICYCL (`BICYCL::QFI`, call sites e.g.
reference include/x86_64/qfi.inl:1-135 and
cpu_cryptosystem_distributed.inl:238-269). The torch/CUDA batched kernels in
cofhe_tpu_torch/ops/ are validated bit-exactly against this module.

Conventions: a form f = (a, b, c) with discriminant D = b^2 - 4ac < 0 and
a > 0 (positive definite). The class of f corresponds to the ideal
a*Z + ((-b + sqrt(D))/2)*Z. Reduced: |b| <= a <= c, and b >= 0 if
|b| == a or a == c.
"""

from __future__ import annotations

from dataclasses import dataclass

from .intmath import gcd, isqrt, kronecker, mod_sym, xgcd


@dataclass(frozen=True)
class Form:
    a: int
    b: int
    c: int

    @property
    def disc(self) -> int:
        return self.b * self.b - 4 * self.a * self.c

    def __iter__(self):
        return iter((self.a, self.b, self.c))

    def __repr__(self) -> str:  # compact; big ints abbreviated
        def s(x):
            t = str(x)
            return t if len(t) <= 24 else f"{t[:10]}..{t[-10:]}<{x.bit_length()}b>"

        return f"Form({s(self.a)}, {s(self.b)}, {s(self.c)})"


def form_from_ab(a: int, b: int, D: int) -> Form:
    """Build (a, b, c) with c derived from the discriminant."""
    num = b * b - D
    assert num % (4 * a) == 0, "invalid (a, b) for discriminant"
    return Form(a, b, num // (4 * a))


def identity_form(D: int) -> Form:
    """Principal (identity) form of discriminant D."""
    b = D & 1  # D ≡ 0 or 1 (mod 4)
    return form_from_ab(1, b, D)


def normalize(f: Form) -> Form:
    """Normalize so that -a < b <= a."""
    a, b, c = f
    r = b % (2 * a)
    if r > a:
        r -= 2 * a
    if r == b:
        return f
    D = f.disc
    return Form(a, r, (r * r - D) // (4 * a))


def is_normal(f: Form) -> bool:
    return -f.a < f.b <= f.a


def is_reduced(f: Form) -> bool:
    a, b, c = f
    if not (-a < b <= a):
        return False
    if a > c:
        return False
    if a == c and b < 0:
        return False
    return True


def reduce_form(f: Form) -> Form:
    """Full reduction of a positive-definite form."""
    f = normalize(f)
    a, b, c = f
    D = f.disc
    while a > c or (a == c and b < 0):
        # rho step: (a,b,c) -> normalize(c, -b, a)
        a, b = c, -b
        r = b % (2 * a)
        if r > a:
            r -= 2 * a
        b = r
        c = (b * b - D) // (4 * a)
    return Form(a, b, c)


def neg(f: Form) -> Form:
    """Inverse class. Keeps reduced forms reduced (boundary cases fixed up)."""
    a, b, c = f
    if b == a or a == c:
        return Form(a, b, c)  # ambiguous-boundary: self-inverse representative
    return Form(a, -b, c)


def compose(f1: Form, f2: Form) -> Form:
    """Gauss composition of two forms of the same discriminant, then reduce.

    Uses the standard ideal-product formula: with s = (b1+b2)/2,
    g = gcd(a1, a2, s) = u*a1 + v*a2 + w*s,
      a3 = a1*a2 / g^2
      b3 = (u*a1*b2 + v*a2*b1 + w*(b1*b2 + D)/2) / g   (mod 2*a3)
    """
    D = f1.disc
    a1, b1, _c1 = f1
    a2, b2, _c2 = f2
    s = (b1 + b2) // 2
    g0, u0, v0 = xgcd(a1, a2)
    g, x, y = xgcd(g0, s)
    u = x * u0
    v = x * v0
    w = y
    g2 = g * g
    a3 = (a1 * a2) // g2
    num = u * a1 * b2 + v * a2 * b1 + w * ((b1 * b2 + D) // 2)
    assert num % g == 0
    b3 = (num // g) % (2 * a3)
    c3 = (b3 * b3 - D) // (4 * a3)
    return reduce_form(Form(a3, b3, c3))


def nudupl(f: Form) -> Form:
    """Squaring (specialized composition)."""
    D = f.disc
    a, b, c = f
    g, x, y = xgcd(a, b)  # g = x*a + y*b
    a3 = (a // g) ** 2
    # b3 = (x*a*b + y*(b^2 + D)/2)/g mod 2*a3 ; (b^2+D)/2 = b^2 - 2ac
    num = x * a * b + y * (b * b - 2 * a * c)
    assert num % g == 0
    b3 = (num // g) % (2 * a3)
    c3 = (b3 * b3 - D) // (4 * a3)
    return reduce_form(Form(a3, b3, c3))


def nupow(f: Form, n: int) -> Form:
    """f^n via 4-bit fixed-window left-to-right exponentiation."""
    D = f.disc
    if n == 0:
        return identity_form(D)
    if n < 0:
        return nupow(neg(f), -n)
    if n == 1:
        return reduce_form(f)
    w = 4
    # precompute odd powers f^1, f^3, ..., f^15
    f = reduce_form(f)
    f2 = nudupl(f)
    tab = [f]
    for _ in range(1, 1 << (w - 1)):
        tab.append(compose(tab[-1], f2))  # tab[i] = f^(2i+1)
    r = None
    nb = n.bit_length()
    j = nb - 1
    while j >= 0:
        if (n >> j) & 1 == 0:
            r = nudupl(r)
            j -= 1
            continue
        # take window of up to w bits ending at lowest set bit
        lo = max(j - w + 1, 0)
        while (n >> lo) & 1 == 0:
            lo += 1
        width = j - lo + 1
        digit = (n >> lo) & ((1 << width) - 1)  # odd
        if r is None:
            r = tab[digit >> 1]
        else:
            for _ in range(width):
                r = nudupl(r)
            r = compose(r, tab[digit >> 1])
        j = lo - 1  # trailing zeros below the window fall to later iterations
    return r


def sqrt_mod_prime(a: int, p: int) -> int | None:
    """Tonelli-Shanks; returns r with r^2 = a mod p, or None."""
    a %= p
    if p == 2:
        return a
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # Tonelli-Shanks
    q = p - 1
    s = 0
    while q % 2 == 0:
        q //= 2
        s += 1
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        t2 = t
        i = 0
        while t2 != 1:
            t2 = t2 * t2 % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, b * b % p
        t = t * c % p
        r = r * b % p
    return r


def prime_form(D: int, l: int) -> Form | None:
    """Reduced form above the odd prime l (norm-l ideal), or None if l is
    inert. Requires l odd prime not dividing D's conductor issues."""
    if kronecker(D, l) == -1:
        return None
    r = sqrt_mod_prime(D, l)
    if r is None:
        return None
    # need b ≡ D (mod 2) and b^2 ≡ D (mod 4l)
    b = r
    if (b - D) % 2 != 0:
        b = l - b if l > b else b + l  # flip parity via b -> b ± l (l odd)
        b %= 2 * l
    if (b * b - D) % (4 * l) != 0:
        b = 2 * l - b
        b %= 2 * l
        if (b - D) % 2 != 0:
            b = (b + l) % (2 * l)
    if (b * b - D) % (4 * l) != 0:
        return None
    return reduce_form(form_from_ab(l, b, D))


def lift_form(fK: Form, DK: int, cond: int) -> Form:
    """Lift a class from Cl(DK) to Cl(cond^2 * DK): (a, b) -> (a, b*cond mod 2a)
    for gcd(a, cond) = 1. This is the `from_Cl_DeltaK_to_Cl_Delta` analogue
    (reference cpu_cryptosystem_distributed.inl:251)."""
    a, b, _ = fK
    assert gcd(a, cond) == 1
    D = cond * cond * DK
    b2 = (b * cond) % (2 * a)
    return reduce_form(form_from_ab(a, b2, D))


def form_class_bound(D: int) -> int:
    """Crude upper bound on sqrt(|D|/3) — max `a` of a reduced form."""
    return isqrt(abs(D) // 3) + 1


def enumerate_reduced_forms(D: int) -> list[Form]:
    """Brute-force all reduced forms of discriminant D (small |D| only)."""
    out = []
    amax = form_class_bound(D)
    for a in range(1, amax + 1):
        for b in range(-a + 1, a + 1):
            num = b * b - D
            if num % (4 * a) != 0:
                continue
            c = num // (4 * a)
            if c < a:
                continue
            if a == c and b < 0:
                continue
            if gcd(gcd(a, b), c) != 1:
                continue  # only primitive forms
            out.append(Form(a, b, c))
    return out
