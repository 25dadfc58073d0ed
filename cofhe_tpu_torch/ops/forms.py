"""Batched binary-quadratic-form helpers and the exact reduction tail
(torch port of the subset of cofhe_tpu/ops/forms.py that the v2 compose
path uses).

A batch of forms is a `BForm` of int32 limb tensors: a, b, c magnitudes of
shape (..., L) and the sign of b of shape (...,). Reduced forms are unique,
so every function here is checked by its canonical outputs only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.qfi import Form
from . import limb as lb

I32 = torch.int32
F32 = torch.float32


class BForm(NamedTuple):
    a: torch.Tensor       # (..., L) magnitude, a > 0
    b_sign: torch.Tensor  # (...,) in {-1, 0, 1}
    b: torch.Tensor       # (..., L) magnitude
    c: torch.Tensor       # (..., L) magnitude, c > 0


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
