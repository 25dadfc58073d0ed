"""Batched binary-quadratic-form helpers, the exact reduction tail and the
v1 composition (torch port of cofhe_tpu/ops/forms.py).

A batch of forms is a `BForm` of int32 limb tensors: a, b, c magnitudes of
shape (..., L) and the sign of b of shape (...,). Reduced forms are unique,
so every function here is checked by its canonical outputs only.

The v1 composition (`compose_batch`, `nudupl_batch`) is the JAX package's
first group law, which its v2 (ops/forms2.py) replaced on every path; it
is kept, as there, as an independent implementation: batched Gauss
composition with two divstep xgcds whose Bezout residues are taken mod a2
(ops/xgcd.py), mu by schoolbook long division, c3 by exact Hensel division,
then `reduce_batch` from the unreduced form. It runs in torch ops only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.qfi import Form
from . import limb as lb
from .xgcd import xgcd_mod

I32 = torch.int32
F32 = torch.float32


class BForm(NamedTuple):
    a: torch.Tensor       # (..., L) magnitude, a > 0
    b_sign: torch.Tensor  # (...,) in {-1, 0, 1}
    b: torch.Tensor       # (..., L) magnitude
    c: torch.Tensor       # (..., L) magnitude, c > 0


@dataclass(frozen=True)
class FormSpec:
    """Static sizing of the v1 composition for one discriminant."""

    disc_bits: int   # bits of |Delta|
    L: int           # limbs of a, b, c buffers
    n_bits: int      # xgcd bit bound

    @staticmethod
    def for_disc_bits(disc_bits: int) -> "FormSpec":
        L = (disc_bits + 16 * 6) // 16 + 1
        L = ((L + 7) // 8) * 8
        # the xgcd bound covers rotated operands (c ~ |Delta|/4a can reach
        # disc_bits); its early exit keeps the common ~disc/2-bit case cheap
        return FormSpec(disc_bits=disc_bits, L=L, n_bits=disc_bits + 32)


# ---------------------------------------------------------------------------
# host conversion / selection helpers
# ---------------------------------------------------------------------------


def bform_from_numpy(a, b_sign, b, c, device) -> BForm:
    """BForm on `device` from the numpy arrays the JAX package holds."""
    def t(x):
        return torch.tensor(np.asarray(x, dtype=np.int32), device=device)

    return BForm(t(a), t(b_sign), t(b), t(c))


def bform_from_forms(forms, L: int, device) -> BForm:
    a = lb.ints_to_limbs([f.a for f in forms], L)
    bs, b = lb.ints_to_signed([f.b for f in forms], L)
    c = lb.ints_to_limbs([f.c for f in forms], L)
    return bform_from_numpy(a, bs, b, c, device)


def bform_to_forms(bf: BForm) -> list[Form]:
    av = lb.limbs_to_ints(bf.a)
    bv = lb.limbs_to_ints(bf.b, bf.b_sign)
    cv = lb.limbs_to_ints(bf.c)
    return [Form(x, y, z) for x, y, z in zip(av, bv, cv)]


def bform_select(mask, t: BForm, f: BForm) -> BForm:
    m1 = mask[..., None]
    return BForm(torch.where(m1, t.a, f.a), torch.where(mask, t.b_sign, f.b_sign),
                 torch.where(m1, t.b, f.b), torch.where(m1, t.c, f.c))


def bform_broadcast(bf: BForm, batch: int) -> BForm:
    return BForm(bf.a.expand(batch, bf.a.shape[-1]),
                 bf.b_sign.expand(batch),
                 bf.b.expand(batch, bf.b.shape[-1]),
                 bf.c.expand(batch, bf.c.shape[-1]))


def bform_neg(bf: BForm) -> BForm:
    """Class inverse of a REDUCED form: (a, -b, c), except on the boundary
    |b| == a or a == c where the reduced inverse keeps b (core.qfi.neg)."""
    boundary = (lb.mag_cmp(bf.b, bf.a) == 0) | (lb.mag_cmp(bf.a, bf.c) == 0)
    s = torch.where(boundary, bf.b_sign, -bf.b_sign)
    return BForm(bf.a, s, bf.b, bf.c)


def rotate_to_odd(bf: BForm) -> BForm:
    """(a,b,c) ~ (c,-b,a) when a is even (then c is odd)."""
    even = (bf.a[..., 0] & 1) == 0
    return bform_select(even, BForm(bf.c, -bf.b_sign, bf.b, bf.a), bf)


# ---------------------------------------------------------------------------
# reduction (exact tail)
# ---------------------------------------------------------------------------


def _scalar_mul_mag(mag, scalar_abs):
    """mag * scalar_abs (0 <= scalar_abs < 2^16) -> redundant NONNEG limbs
    (< 2^25); the 8-bit split avoids int32 overflow."""
    lo = (scalar_abs & 0xFF)[..., None] * mag          # <= 2^24
    t = (scalar_abs >> 8)[..., None] * mag             # <= 2^24
    return lo + ((t & 0xFF) << 8) + lb._shift_up(t >> 8, 1)


def _is_normal(bf: BForm):
    c = lb.mag_cmp(bf.b, bf.a)
    return (c < 0) | ((c == 0) & (bf.b_sign >= 0))


def _is_reduced(bf: BForm):
    ac = lb.mag_cmp(bf.a, bf.c)
    return _is_normal(bf) & ((ac < 0) | ((ac == 0) & (bf.b_sign >= 0)))


def _normalize_step(bf: BForm) -> BForm:
    """One masked move of b toward (-a, a]: b -= 2*a*q for an f32-estimated
    quotient q = qd * 2^shift (qd < 2^14, per-element shift), with c updated
    as c' = q*(a*q - b) + c. Estimate errors are repaired by later steps."""
    a_mant, a_exp = lb.mag_float(bf.a)
    b_mant, b_exp = lb.mag_float(bf.b)
    ratio = b_mant / a_mant.clamp(min=1.0)
    e = b_exp - a_exp - 1  # q ~= ratio * 2^e
    # renormalize: ratio = frac * 2^lr with frac in [1, 2)
    lr = torch.floor(torch.log2(ratio.clamp(min=1e-30))).to(I32)
    frac = ratio * torch.exp2((-lr).clamp(-126, 126).to(F32))
    qbits = lr + e + 1
    shift = (qbits - 13).clamp(min=0)
    expo = lr + e - shift
    qd = torch.round(frac * torch.exp2(expo.clamp(-30, 14).to(F32)))
    qd = qd.clamp(0.0, 16383.0).to(I32)
    # |b| > a needs q >= 1 (the f32 estimate can round b/(2a) in (0.5, 1)
    # down to 0, which would loop forever)
    qd = torch.where((lb.mag_cmp(bf.b, bf.a) > 0) & (qd == 0), 1, qd)
    qsign = bf.b_sign

    def shifted(mag_red):
        """(redundant nonneg limbs < 2^25) * 2^shift, carry-fixed."""
        return lb.mag_shl_bits_dyn(lb.canonicalize_fast(mag_red)[1], shift)

    two_aq = shifted(_scalar_mul_mag(bf.a, 2 * qd))
    bs, bm = lb.canonicalize_fast(bf.b_sign[..., None] * bf.b
                                  - qsign[..., None] * two_aq)
    aq = shifted(_scalar_mul_mag(bf.a, qd))
    t_s, t_m = lb.sm_sub((qsign, aq), (bf.b_sign, bf.b))
    u_mag = shifted(_scalar_mul_mag(t_m, qd))
    cs, cm = lb.canonicalize_fast((qsign * t_s)[..., None] * u_mag + bf.c)
    # boundary: b' == -a  ->  use the +a representative (same c)
    neg_boundary = (bs < 0) & (lb.mag_cmp(bm, bf.a) == 0)
    bs = torch.where(neg_boundary, 1, bs)
    return BForm(bf.a, bs, bm, cm)


def reduce_batch(bf: BForm, max_iters: int) -> BForm:
    """Masked (normalize | rho) iterations until every element is reduced
    (at most max_iters)."""
    for _ in range(max_iters):
        reduced = _is_reduced(bf)
        if bool(reduced.all()):
            break
        need_rho = _is_normal(bf) & ~reduced
        rho = BForm(bf.c, -bf.b_sign, bf.b, bf.a)
        stepped = _normalize_step(bform_select(need_rho, rho, bf))
        bf = bform_select(reduced, bf, stepped)
    return bf


# ---------------------------------------------------------------------------
# v1 composition
# ---------------------------------------------------------------------------


def _sm_half(sign, mag):
    """(sign, mag) / 2 for even values."""
    return sign, lb.mag_shr_bits(mag, 1)


def _mulmod(x_mag, y_mag, m_mag, L: int, Lq: int):
    """x*y mod m for magnitudes (x, y < m)."""
    prod = lb.mag_mul(x_mag, y_mag)  # 2L
    _, r = lb.mag_divmod(prod, lb.resize(m_mag, prod.shape[-1]), Lq)
    return lb.resize(r, L)


def _c_from_ab(a3, b3s, b3m, delta4_mag, L: int):
    """c3 = ((b3/2)^2 + |Delta|/4) / a3: a3 = 2^e * odd, shift, then Hensel."""
    L2 = 2 * L
    _, b3hm = _sm_half(b3s, b3m)
    sq = lb.mag_mul(b3hm, b3hm, L2)
    _, csum = lb.canonicalize_fast(lb.resize(sq, L2) + lb.resize(delta4_mag, L2))
    e = lb.mag_v2(a3)
    a3_odd = lb.mag_shr_bits_dyn(a3, e)
    csum_shifted = lb.mag_shr_bits_dyn(csum, e.clamp(max=16 * L2 - 1))
    return lb.mag_divexact_odd(csum_shifted, lb.resize(a3_odd, L2), L)


def compose_batch(F1: BForm, F2: BForm, spec: FormSpec, delta4_mag: torch.Tensor,
                  nbits: int | None = None, reduce_iters: int | None = None) -> BForm:
    """Gauss composition + reduction. F1, F2 reduced forms of the same
    discriminant (F1 may be a skewed form like f^m with tiny even a and
    huge c: sizes stay bounded because only a2 is rotated odd).

    * order the operands so a1 <= a2 and rotate F2 to odd a2, which keeps
      a1 * c2 <= |Delta|/4 inside the L / 2L buffers;
    * s = (b1 + b2) / 2; d1 = gcd(a2, a1) with beta the a1-coefficient mod
      a2; g = gcd(d1, |s|) with xi, eta the coefficients of (d1, |s|),
      skipped as (1, 1, 0) when every lane has d1 == 1 (one host test);
    * u ≡ xi * beta, w ≡ sign(s) * eta (mod a2) form one Bezout triple
      u*a1 + v*a2 + w*s = g;
    * mu = [u*(b2 - b1) - 2*w*c1] mod 2*m2 (m2 = a2/g): the modulus is 2*m2,
      since b3 is only determined mod 2*a3;
    * a3 = (a1/g) * m2, b3 = b1 + (a1/g) * mu, c3 = ((b3/2)^2 + |Delta|/4)
      / a3, then `reduce_batch` (reduce_iters, default disc_bits + 256)."""
    L = spec.L
    L2 = 2 * L
    nbits = nbits if nbits is not None else spec.n_bits
    reduce_iters = reduce_iters if reduce_iters is not None else spec.disc_bits + 256

    swap = lb.mag_cmp(F1.a, F2.a) > 0
    F1n = bform_select(swap, F2, F1)
    F2n = rotate_to_odd(bform_select(swap, F1, F2))
    a1, b1s, b1m, c1 = F1n
    a2, b2s, b2m, c2 = F2n

    # s = (b1 + b2) / 2  (b's are even: 4 | Delta)
    ss, smag = lb.sm_add((b1s, b1m), (b2s, b2m))
    smag = lb.mag_shr_bits(smag, 1)

    d1, _alpha, beta = xgcd_mod(a2, a1, a2, nbits)
    # random reduced forms are coprime with overwhelming probability: when
    # EVERY lane has d1 == 1 the second xgcd is skipped
    d1_is_one = (d1[..., 0] == 1) & (d1.abs().sum(-1) == 1)
    if bool(d1_is_one.all()):
        g = lb.one_limbs(d1.shape[:-1], d1.shape[-1], d1.device)
        xi, eta = g, torch.zeros_like(d1)
    else:
        g, xi, eta = xgcd_mod(d1, smag, a2, nbits)

    # m2 = a2/g, a1g = a1/g (g odd: it divides the odd a2 through d1)
    m2 = lb.mag_divexact_odd(a2, g, L)
    a1g = lb.mag_divexact_odd(a1, g, L)
    u = _mulmod(xi, beta, a2, L, L + 2)

    # mu_num = u*(b2 - b1) - 2*w*c1  (signed, <= ~3n bits)
    ds, dm = lb.sm_sub((b2s, b2m), (b1s, b1m))
    t1s, t1m = lb.sm_mul((torch.ones_like(ds), u), (ds, dm), L_out=L2)
    wcs, wcm = lb.sm_mul((ss, eta), (torch.ones_like(ss), c1), L_out=L2)
    wcm = lb.mag_shl_bits(wcm, 1, L2)
    nums, numm = lb.sm_sub((t1s, t1m), (wcs, wcm))

    # mu = mu_num mod 2*m2 in [0, 2*m2); a negative numerator maps mu to
    # 2*m2 - mu (if nonzero)
    m2x2 = lb.mag_shl_bits(m2, 1, L)
    _, mu = lb.mag_divmod(numm, lb.resize(m2x2, numm.shape[-1]), L2)
    mu = lb.resize(mu, L)
    neg = (nums < 0) & ~lb.mag_is_zero(mu)
    _, mu = lb.canonicalize_fast(torch.where(neg[..., None], m2x2 - mu, mu))

    a3 = lb.mag_mul(a1g, m2, L)
    b3s, b3m = lb.sm_add((b1s, b1m), (torch.ones_like(b1s), lb.mag_mul(a1g, mu, L)))
    c3 = _c_from_ab(a3, b3s, b3m, delta4_mag, L)
    return reduce_batch(BForm(a3, b3s, b3m, c3), reduce_iters)


def nudupl_batch(F: BForm, spec: FormSpec, delta4_mag: torch.Tensor,
                 nbits: int | None = None, reduce_iters: int | None = None) -> BForm:
    """Squaring: one xgcd instead of two. b3 = b - 2*(a/g)*(y*c mod m2),
    a3 = (a/g)^2, with g = gcd(a, b) and y the b-coefficient mod a."""
    L = spec.L
    nbits = nbits if nbits is not None else spec.n_bits
    reduce_iters = reduce_iters if reduce_iters is not None else spec.disc_bits + 256

    a, bs, bm, c = rotate_to_odd(F)
    g, _xa, y = xgcd_mod(a, bm, a, nbits)  # y*|b| ≡ g - xa*a ≡ g (mod a)
    m2 = lb.mag_divexact_odd(a, g, L)      # a/g (odd)
    # mu = (sign(b) * y * c) mod m2
    prod = lb.mag_mul(y, c)  # 2L
    _, mu = lb.mag_divmod(prod, lb.resize(m2, prod.shape[-1]), L + 2)
    mu = lb.resize(mu, L)
    neg = (bs < 0) & ~lb.mag_is_zero(mu)
    _, mu = lb.canonicalize_fast(torch.where(neg[..., None], m2 - mu, mu))

    a3 = lb.mag_mul(m2, m2, L)
    t = lb.mag_mul(m2, mu, L)
    b3s, b3m = lb.sm_sub((bs, bm), (torch.ones_like(bs), lb.mag_shl_bits(t, 1, L)))
    c3 = _c_from_ab(a3, b3s, b3m, delta4_mag, L)
    return reduce_batch(BForm(a3, b3s, b3m, c3), reduce_iters)
