"""Redundant-limb arithmetic: the v2 hot-loop toolkit (torch port of
cofhe_tpu/ops/rl.py).

Values stay REDUNDANT across loop iterations (balanced limbs after
`carry_pass`) and loops are steered by float32 estimates; only the exact
tails canonicalize. `mod_topdown28` here is the plain version of the
Hopper kernel in csrc/mod_topdown.cu (ops/cuda_group.py dispatches between
them); `mod_topdown`, the 24-bit-digit schedule, stays as a reference.

Loop conditions are host syncs in eager PyTorch. Every loop body below is a
fixed point on finished lanes, so the port may test the condition every few
iterations without changing a result, as long as the iteration caps are
honoured exactly.
"""

from __future__ import annotations

import torch

from . import limb as lb

MASK = lb.MASK
BASE_BITS = lb.BASE_BITS
I32 = torch.int32
F32 = torch.float32


def carry_pass(x):
    """One BALANCED partial carry pass; keeps the value exact. Limbs land in
    [-2^15, 2^15) plus the folded-in carry of the limb below. The top limb
    keeps its own carry (callers leave >= 2 guard limbs so it stays small)."""
    L = x.shape[-1]
    c = (x + (1 << (BASE_BITS - 1))) >> BASE_BITS
    out = x - (c << BASE_BITS) + lb._shift_up(c, 1)
    out[..., L - 1] = x[..., L - 1] + (c[..., L - 2] if L > 1 else 0)
    return out


def carry2(x):
    return carry_pass(carry_pass(x))


def shl_limbs_take(x, j):
    """x * 2^(16 j) for per-element j >= 0 (pure limb relabeling — exact on
    redundant limbs). Truncates limbs that fall off the top."""
    return lb.shl_limbs_dyn(x, j)


def pow2f(e):
    """2^e as f32 for int32 e; 0 for e < -126. Callers clamp e <= 127."""
    bits = (e.clamp(-126, 127) + 127) << 23
    return torch.where(e >= -126, bits.to(I32).view(F32), 0.0)


def log2f_i(mant):
    """floor-ish log2 |mant| as int32 via f32 exponent bits; 0 -> -200."""
    bits = mant.abs().view(I32)
    return torch.where(mant == 0.0, -200, (bits >> 23) - 127).to(I32)


def value_est(x):
    """(mant, top) with value(x) ~= mant * 2^(16 top), mant SIGNED f32, for
    balanced limbs. The all-zero value gives (0.0, 0)."""
    L = x.shape[-1]
    idx = lb._arange(L, x.device)
    top = torch.where(x != 0, idx, 0).amax(-1)
    mant = (x.to(F32) * pow2f(16 * (idx - top[..., None]))).sum(-1)
    return mant, top


def bits_est(mant, top):
    """~bit length of the estimated value as f32; very negative for zero."""
    return 16.0 * top.to(F32) + _log2_f32(mant.abs())


def _log2_f32(v):
    bits = v.clamp(min=1e-30).view(I32)
    e = ((bits >> 23) - 127).to(F32)
    frac = ((bits & 0x7FFFFF) | (127 << 23)).view(F32)  # in [1, 2)
    approx = e + (frac - 1.0) * (2.0 - frac * 0.5) * 0.7219281
    return torch.where(v <= 1e-30, -200.0, approx)


def mod_topdown(x, m_mag, active=None, max_iters: int | None = None):
    """x mod m -> canonical magnitude in [0, m) (width of x), for SIGNED
    redundant x and canonical m >= 1 per element; the plain version of K2.

    A shifted copy of m starts 8-24 bits below x's value; each iteration
    applies a ~24-bit f32-estimated digit split 12+12 against (msh, msh<<12)
    and walks the shift down up to two limbs. Exact canonical tail (<= 2
    fixes) at the end."""
    L = x.shape[-1]
    Lm = m_mag.shape[-1]
    if Lm >= L:
        raise ValueError(f"m width {Lm} must be below x width {L}")
    m = lb.resize(m_mag, L)
    mant_m, top_m = value_est(m)
    bits_m = bits_est(mant_m, top_m)
    if active is None:
        active = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    if max_iters is None:
        max_iters = 2 * L + 80

    def need_work(xc):
        mant_x, top_x = value_est(xc)
        bx = bits_est(mant_x, top_x)
        return active & (bx > bits_m - 0.75), mant_x, top_x, bx

    xc = carry2(x)
    w, mant_x, top_x, bx = need_work(xc)
    wmax = (L - 2 - top_m).to(I32)
    wleft = torch.minimum(
        ((bx - bits_m - 8.0) / 16.0).to(I32).clamp(min=0), wmax)
    _, m12 = lb.canonicalize_fast(m << 12)
    msh = shl_limbs_take(m, wleft)
    m12sh = shl_limbs_take(m12, wleft)
    it = 0
    while it < max_iters and bool(w.any()):
        top_s = top_m + wleft
        ratio = mant_x / mant_m.clamp(min=1e-30)
        scale = pow2f((16 * (top_x - top_s)).clamp(-126, 60))
        qd = torch.round(ratio * scale).clamp(-16777215.0, 16777215.0).to(I32)
        qd = torch.where(w, qd, 0)
        s = torch.sign(qd)
        a = qd.abs()
        lo = (a & 0xFFF) * s
        hi = (a >> 12) * s
        xc = carry2(xc - lo[..., None] * msh - hi[..., None] * m12sh)
        w, mant_x, top_x, bx = need_work(xc)
        for _ in range(2):
            do_shift = (wleft > 0) & (bits_m + 16.0 * wleft > bx - 8.0)
            msh = torch.where(do_shift[..., None], lb._shift_down(msh), msh)
            m12sh = torch.where(do_shift[..., None], lb._shift_down(m12sh), m12sh)
            wleft = wleft - do_shift.to(I32)
        it += 1
    return exact_mod_tail(xc, m)


def digit_est(mant_x, top_x, mant_m, top_m, max_digit_bits: int = 28,
              jmax=None):
    """q = value(x) / value(m) as (qd, j) with q ~= qd * 2^(16 j), qd signed
    int32, |qd| < 2^max_digit_bits, 0 <= j <= jmax; m must be positive.

    Two departures from the JAX package's digit_est, both faults that stall
    its mod_topdown28 (ROADMAP queue 3): the scale's exponent is clamped at
    60, not at max_digit_bits + 2 (ebits - 16 j reaches max_digit_bits + 16
    when mant_x / mant_m is small, and the tighter clamp cuts the digit by
    up to 2^14); and j is clipped to jmax before the digit is taken, so the
    digit belongs to the shift it is applied at (the JAX loop clips j after,
    and its digit then removes ~2^-16 of what it should). The digit clamp
    is the real bound."""
    ratio = mant_x / mant_m.clamp(min=1e-30)
    ebits = 16 * (top_x - top_m)
    qbits = ebits + log2f_i(ratio) + 1
    j = torch.div(qbits - max_digit_bits + 15, 16, rounding_mode="floor").clamp(min=0)
    if jmax is not None:
        j = torch.minimum(j, jmax)
    scale = pow2f((ebits - 16 * j).clamp(-126, 60))
    lim = float((1 << max_digit_bits) - 1)
    qd = torch.round(ratio * scale).clamp(-lim, lim)
    return qd.to(I32), j.to(I32)


def submul_shifted(x, qd, j, m, m14):
    """x - qd * m * 2^(16 j) on redundant limbs, |qd| < 2^28 split 14+14
    against m and m14 = canonical m * 2^14."""
    s = torch.sign(qd)
    a = qd.abs()
    lo = ((a & 0x3FFF) * s)[..., None]
    hi = ((a >> 14) * s)[..., None]
    p = carry_pass(lo * m) + carry_pass(hi * m14)
    return x - shl_limbs_take(p, j)


def mod_topdown28(x, m_mag, active=None, max_iters: int | None = None,
                  iters=None):
    """x mod m with 28-bit estimated digits: the plain version of K2 (port
    of the JAX package's rl.mod_topdown28, same contract and canonical
    output as mod_topdown). Each iteration subtracts qd * m * 2^(16 j)
    (digit_est + submul_shifted) and runs carry2; exact tail of <= 2 fixes.
    `iters`, if given, is a (B,) int32 tensor that receives each lane's
    number of working iterations."""
    L = x.shape[-1]
    Lm = m_mag.shape[-1]
    if Lm >= L:
        raise ValueError(f"m width {Lm} must be below x width {L}")
    m = lb.resize(m_mag, L)
    _, m14 = lb.canonicalize_fast(m << 14)
    mant_m, top_m = value_est(m)
    bits_m = bits_est(mant_m, top_m)
    if active is None:
        active = torch.ones(x.shape[:-1], dtype=torch.bool, device=x.device)
    if max_iters is None:
        max_iters = L + 60
    jmax = (L - 2 - top_m).clamp(min=0)

    def need_work(xc):
        mant_x, top_x = value_est(xc)
        return active & (bits_est(mant_x, top_x) > bits_m - 0.75), mant_x, top_x

    xc = carry2(x)
    w, mant_x, top_x = need_work(xc)
    count = torch.zeros_like(top_m)
    it = 0
    while it < max_iters and bool(w.any()):
        qd, j = digit_est(mant_x, top_x, mant_m, top_m, 28, jmax)
        qd = torch.where(w, qd, 0)
        count = count + w.to(I32)
        xc = carry2(submul_shifted(xc, qd, j, m, m14))
        w, mant_x, top_x = need_work(xc)
        it += 1
    if iters is not None:
        iters.copy_(count)
    return exact_mod_tail(xc, m)


# ---------------------------------------------- 64-bit steering (K3 wide)


def pow2d(e):
    """2^e as float64 for int64 e, built from its exponent bits; 0 below
    -1022, clamped at 1023."""
    bits = (e.clamp(-1022, 1023) + 1023) << 52
    return torch.where(e >= -1022, bits.to(torch.int64).view(torch.float64), 0.0)


def value_est_wide(x):
    """(mant float64, top int64) with value(x) ~= mant * 2^(16 top) for
    balanced limbs, from the top four limbs: the top three summed exactly
    in int64, the fourth added in float64, so the result does not depend
    on a summation order. The all-zero value gives (0.0, 0)."""
    L = x.shape[-1]
    idx = lb._arange(L, x.device).long()
    top = torch.where(x != 0, idx, 0).amax(-1)
    xl = x.long()

    def limb(k):
        i = top - k
        v = torch.gather(xl, -1, i.clamp(min=0)[..., None])[..., 0]
        return torch.where(i >= 0, v, 0)

    p = (limb(0) << 32) + (limb(1) << 16) + limb(2)
    mant = (p.to(torch.float64) + limb(3).to(torch.float64) * 2.0 ** -16) * 2.0 ** -32
    return mant, top


def spread_carry(s, ndig: int):
    """int64 limb sums |s| < 2^(16 ndig - 2) -> int32 limbs of the same
    value: each sum is split into ndig balanced 16-bit digits (the last
    one takes the rest) and digit k moves k limbs up, so every limb below
    the top lands within ndig * 2^15. The top limb keeps everything that
    would pass it, as carry_pass's top limb does."""
    L = s.shape[-1]
    digs, rests = [], [s]
    r = s
    for _ in range(ndig - 1):
        d = ((r + (1 << 15)) & 0xFFFF) - (1 << 15)
        digs.append(d)
        r = (r - d) >> 16
        rests.append(r)
    digs.append(r)
    out = digs[0].clone()
    for k in range(1, ndig):
        out = out + lb._shift_up(digs[k], k)
    top = s[..., L - 1]
    for k in range(1, ndig):
        if L - 1 - k >= 0:
            top = top + rests[k][..., L - 1 - k]
    out[..., L - 1] = top
    return out.to(I32)


def exact_mod_tail(xf, m):
    """|xf| <~ 2m -> xf mod m canonical: canonicalize, then fold the sign /
    subtract m at most twice."""
    s, mag = lb.canonicalize_fast(xf)
    for _ in range(2):
        ge = (s > 0) & (lb.mag_cmp(mag, m) >= 0)
        neg = s < 0
        delta = torch.where(neg[..., None], m, 0) - torch.where(ge[..., None], m, 0)
        s, mag = lb.canonicalize_fast(s[..., None] * mag + delta)
    return mag


def redc_pow16(x, d_mag, steps: int, active=None, inv=None):
    """x * 2^(-16*steps) mod d for ODD canonical d and nonneg redundant x,
    as a value in [0, x / 2^(16*steps) + d) of x's width.

    One Montgomery reduction with a `steps`-limb digit: q = -x * d^-1 mod
    2^(16*steps), then (x + q*d) / 2^(16*steps) exactly. It equals the JAX
    package's limb-by-limb REDC modulo d (both land in [0, 2d) for the
    x < 2^(16*steps) the compose passes), in ~1/100 of its eager ops.
    `inv`, when the caller already has it, is d^-1 mod 2^(16*steps). Lanes
    outside `active` return garbage; when no lane is active the result is
    carry_pass(x)."""
    if active is not None and not bool(active.any()):
        return carry_pass(x)
    Lx = x.shape[-1]
    Ld = d_mag.shape[-1]
    _, xm = lb.canonicalize_fast(x)
    if inv is None:
        inv = lb.inv_pow2(d_mag, steps)
    ninv = lb._negate_mag_fast(inv)
    q = lb.mag_mul(lb.resize(xm, steps), ninv, steps)
    if active is not None:
        q = torch.where(active[..., None], q, 0)
    Ly = max(Lx, steps + Ld) + 1
    y = lb.canonicalize_nonneg(lb.resize(xm, Ly) + lb.mag_mul(q, d_mag, Ly))
    return lb.resize(y[..., steps:], Lx)
