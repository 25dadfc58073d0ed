"""Redundant-limb arithmetic: the v2 hot-loop toolkit (torch port of
cofhe_tpu/ops/rl.py).

Values stay REDUNDANT across loop iterations (balanced limbs after
`carry_pass`) and loops are steered by float32 estimates; only the exact
tails canonicalize. `mod_topdown28` here is the plain version of the
Hopper kernel in csrc/mod_topdown.cu (ops/cuda_group.py dispatches between
them); `mod_topdown`, the 24-bit-digit schedule, stays as a reference.

`lehmer_euclid`, the engine of the opt-in NUCOMP composition tail, is the
plain version of K7 (csrc/lehmer_euclid.cu; ops/cuda_group.py dispatches):
the CPU runs it, and chip_smoke holds K7 to it on the card.

Loop conditions are host syncs in eager PyTorch. Every loop body below is a
fixed point on finished lanes, so the port may test the condition every few
iterations without changing a result, as long as the iteration caps are
honoured exactly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import limb as lb

MASK = lb.MASK
BASE_BITS = lb.BASE_BITS
I32 = torch.int32
F32 = torch.float32

# host syncs of the torch-op loops: one exit test every SYNC_EVERY iterations
SYNC_EVERY = 4


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


# XLA-CPU's order for a row of 19-32 terms (found by probing the JAX
# package's jitted sums on the CPU with pairs of cancelling terms):
# (lanes, chunk offsets, tail start, tail in two accumulators). Lane k
# sums terms offset + k over the offsets in order, the lanes are reduced
# by halving (lane k + lane k + lanes/2, ...), and the terms from the tail
# start on are added one by one, or, with two accumulators, the even ones
# of each pair into the lane sum and the odd ones into a second sum added
# before an unpaired last term.
_XLA_PLANS = {19: (8, (0, 8), 16, True)}
_XLA_PLANS.update({n: (4, (0, 4, 8, 12), 16, True) for n in range(20, 24)})
_XLA_PLANS.update({n: (8, (0, 8, 16), 24, True) for n in range(24, 28)})
_XLA_PLANS.update({n: (4, (0, 8, 16, 12, 4, 20), 24, False) for n in range(28, 32)})
_XLA_PLANS[32] = (8, (0, 8, 16, 24), 32, True)


def _sum_xla_row(t):
    """Sum of at most 32 f32 terms over the last axis in XLA-CPU's order:
    left to right from 0.0 for at most 18 terms, _XLA_PLANS above."""
    n = t.shape[-1]
    if n not in _XLA_PLANS:
        acc = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
        for k in range(n):
            acc = acc + t[..., k]
        return acc
    lanes, offs, start, paired = _XLA_PLANS[n]
    acc = t[..., offs[0]:offs[0] + lanes]
    for o in offs[1:]:
        acc = acc + t[..., o:o + lanes]
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    acc, q = acc[..., 0], start
    if paired:
        odd = torch.zeros_like(acc)
        for q in range(start, n - 1, 2):
            acc, odd = acc + t[..., q], odd + t[..., q + 1]
        q = start + 2 * ((n - start) // 2)
        acc = acc + odd
    for k in range(q, n):
        acc = acc + t[..., k]
    return acc


def _sum_ordered(t):
    """Sum of f32 terms over the last axis, rounded step by step in the
    order XLA's CPU backend gives the JAX package's value_est: a row of at
    most 32 terms as `_sum_xla_row`; a row of more than 32 is padded with
    zeros to a multiple of 32 (the smaller half of the padding in front),
    cut into windows of 32, each window summed left to right, and the row
    of window sums reduced the same way."""
    n = t.shape[-1]
    if n <= 32:
        return _sum_xla_row(t)
    pad = -n % 32
    t = F.pad(t, (pad // 2, pad - pad // 2))
    t = t.reshape(*t.shape[:-1], t.shape[-1] // 32, 32)
    win = torch.zeros(t.shape[:-1], dtype=t.dtype, device=t.device)
    for i in range(32):
        win = win + t[..., i]
    acc = torch.zeros(t.shape[:-2], dtype=t.dtype, device=t.device)
    for k in range(win.shape[-1]):
        acc = acc + win[..., k]
    return acc


def value_est_ordered(x):
    """value_est with its mantissa summed as the JAX function sums it on
    the CPU (`_sum_ordered`), so that decisions taken on it are the JAX
    package's, bit for bit, at every width up to 288 limbs. Costs ~40
    torch ops more than value_est; only the NUCOMP tail, whose cofactors
    depend on every rounding of its steering, takes it (and K7,
    csrc/lehmer_euclid.cu, sums the same terms in the same order)."""
    L = x.shape[-1]
    idx = lb._arange(L, x.device)
    top = torch.where(x != 0, idx, 0).amax(-1)
    return _sum_ordered(x.to(F32) * pow2f(16 * (idx - top[..., None]))), top


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
              jmax=None, exp_clamp: int = 60):
    """q = value(x) / value(m) as (qd, j) with q ~= qd * 2^(16 j), qd signed
    int32, |qd| < 2^max_digit_bits, 0 <= j <= jmax; m must be positive.

    Two departures from the JAX package's digit_est, both faults that stall
    its mod_topdown28 (ROADMAP queue 3): the scale's exponent is clamped at
    exp_clamp = 60 by default, not at max_digit_bits + 2 (ebits - 16 j
    reaches max_digit_bits + 16 when mant_x / mant_m is small, and the
    tighter clamp cuts the digit by up to 2^14); and j is clipped to jmax
    before the digit is taken, so the digit belongs to the shift it is
    applied at (the JAX loop clips j after, and its digit then removes
    ~2^-16 of what it should). The digit clamp is the real bound. A caller
    that must give the JAX digits passes exp_clamp=max_digit_bits + 2 and
    no jmax."""
    ratio = mant_x / mant_m.clamp(min=1e-30)
    ebits = 16 * (top_x - top_m)
    qbits = ebits + log2f_i(ratio) + 1
    j = torch.div(qbits - max_digit_bits + 15, 16, rounding_mode="floor").clamp(min=0)
    if jmax is not None:
        j = torch.minimum(j, jmax)
    scale = pow2f((ebits - 16 * j).clamp(-126, exp_clamp))
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


def lehmer_euclid(r0_mag, r1_mag, bits_stop, max_groups: int,
                  sim_steps: int = 8, active=None, iters=None):
    """Grouped partial extended Euclid (Lehmer style), batched: the NUCOMP
    tail's walk down the continued fraction of r0 / r1.

    Keeps EXACT invariants r_i = x_i * r0 + y_i * r1 for two rows (prev,
    cur), starting ((r0, 1, 0), (r1, 0, 1)). Per group it simulates up to
    `sim_steps` continued-fraction steps on ~27-bit int32 top-word
    approximations of (rp, rc), accumulating a 2x2 matrix with entries
    bounded by 2^13, and applies it once to the full-width redundant
    (r, x, y) rows (int32-exact against balanced limbs). A lane whose
    quotient exceeds what a 2^13 matrix can express (bits(rp) - bits(rc)
    > 20, a "big" lane) takes one shifted ~24-bit digit step instead:
    (rp, xp, yp) -= qd * 2^(16 jj) * (rc, xc, yc). Any unimodular step keeps
    the invariants, so estimate noise can only slow progress.

    Stops per lane when bits(rc) <= bits_stop, when yc outgrows
    bits(r0) - bits_stop + 24, or at max_groups. Returns redundant signed
    (rp, rc, xp, xc, yp, yc) and parity (row swaps mod 2, the sign of
    det [[xp, yp], [xc, yc]]).

    The plain version of K7 (csrc/lehmer_euclid.cu, which the card runs
    through cuda_group.lehmer_euclid). It gives the JAX function's seven
    outputs on every lane, limb for limb, at every width up to 288 limbs:
    its estimates are `value_est_ordered`, summed in XLA-CPU's order; the
    digit of a big lane is `digit_est` with the JAX exponent clamp
    (max_digit_bits + 2 = 26, not this module's 60); the digit step is
    computed on every lane with no condition and kept only where a lane is
    big (the JAX `lax.cond` on
    any(big) selects the same); and a group that runs after the JAX loop
    would have left (the host tests its condition every SYNC_EVERY groups)
    is masked to the identity on the device. `iters`, if given, is a (B,)
    int32 tensor that receives each lane's number of working groups."""
    dev = r0_mag.device
    if active is None:
        active = torch.ones(r0_mag.shape[:-1], dtype=torch.bool, device=dev)
    mant0, top0 = value_est_ordered(r0_mag)
    y_cap = bits_est(mant0, top0) - bits_stop + 24.0
    one = lb.one_limbs(r0_mag.shape[:-1], r0_mag.shape[-1], dev)
    zero = torch.zeros_like(r0_mag)
    LIM = 1 << 13

    def ests(v):
        mant, top = value_est_ordered(v)
        return mant, top, bits_est(mant, top)

    def submul_shift_red(x, v, qd, jj):
        s = torch.sign(qd)
        a = qd.abs()
        lo = ((a & 0xFFF) * s)[..., None]
        hi = ((a >> 12) * s)[..., None]
        v12 = carry_pass(v << 12)
        p = carry_pass(lo * v) + carry_pass(hi * v12)
        return carry_pass(x - shl_limbs_take(p, jj))

    def top_word(mant, top, sh):
        """round(mant * 2^(16 top - sh)), the exponent clipped to
        [-126, 30] in f32 and truncated, as the JAX function does."""
        e = ((16 * top).to(F32) - sh).clamp(-126.0, 30.0).to(I32)
        return torch.round(mant * pow2f(e)).to(I32)

    rp, rc = carry_pass(r0_mag.to(I32)), carry_pass(r1_mag.to(I32))
    xp, xc, yp, yc = one, zero, zero, one
    par = torch.zeros(r0_mag.shape[:-1], dtype=I32, device=dev)
    w = active & (bits_est(*value_est_ordered(r1_mag)) > bits_stop)
    count = torch.zeros_like(par)
    for it in range(max_groups):
        go = w.any()  # the JAX loop's condition, on the device
        if it % SYNC_EVERY == 0 and not bool(go):
            break
        mant_p, top_p, bits_p = ests(rp)
        mant_c, top_c, bits_c = ests(rc)
        bits_y = ests(yc)[2]
        # fresh work mask; the carried w (one group stale) feeds the exit
        w_f = active & (bits_c > bits_stop) & (bits_y < y_cap)
        lane_on = w & w_f
        big = lane_on & (bits_p - bits_c > 20.0)
        qd, jj = digit_est(mant_p, top_p, mant_c.abs(), top_c, 24,
                           exp_clamp=24 + 2)
        qd = torch.where(big, qd * torch.sign(mant_c).to(I32), 0)
        rp_d = submul_shift_red(rp, rc, qd, jj)
        xp_d = submul_shift_red(xp, xc, qd, jj)
        yp_d = submul_shift_red(yp, yc, qd, jj)

        # Lehmer group on ~27-bit top words aligned at the larger row's scale
        sh = torch.maximum(bits_p, bits_c) - 26.0
        up, vc = top_word(mant_p, top_p, sh), top_word(mant_c, top_c, sh)
        mp0, mp1 = torch.ones_like(up), torch.zeros_like(up)
        mc0, mc1 = torch.zeros_like(up), torch.ones_like(up)
        parg = torch.zeros_like(up)
        sim_on = lane_on & ~big
        for _ in range(sim_steps):
            emax = torch.maximum(mc0.abs(), mc1.abs())
            epmx = torch.maximum(mp0.abs(), mp1.abs())
            qmax = torch.div(LIM - epmx, emax.clamp(min=1), rounding_mode="floor")
            can = sim_on & (vc.abs() > 32) & (qmax > 0)
            q = torch.div(up, torch.where(vc == 0, 1, vc), rounding_mode="floor")
            q = torch.where(can, torch.minimum(torch.maximum(q, -qmax), qmax), 0)
            up, vc = torch.where(can, vc, up), torch.where(can, up - q * vc, vc)
            mp0, mp1, mc0, mc1 = (torch.where(can, mc0, mp0),
                                  torch.where(can, mc1, mp1),
                                  torch.where(can, mp0 - q * mc0, mc0),
                                  torch.where(can, mp1 - q * mc1, mc1))
            parg = parg ^ can.to(I32)

        def app(a0, a1, pv, cv, dv):
            out = carry_pass(a0[..., None] * pv + a1[..., None] * cv)
            return torch.where(big[..., None], dv, out)

        new = (app(mp0, mp1, rp, rc, rp_d), app(mc0, mc1, rp, rc, rc),
               app(mp0, mp1, xp, xc, xp_d), app(mc0, mc1, xp, xc, xc),
               app(mp0, mp1, yp, yc, yp_d), app(mc0, mc1, yp, yc, yc),
               par ^ parg, w_f)
        rp, rc, xp, xc, yp, yc, par, w = (torch.where(go, n, o) for n, o in zip(
            new, (rp, rc, xp, xc, yp, yc, par, w)))
        count = count + (lane_on & go).to(I32)
    if iters is not None:
        iters.copy_(count)
    return rp, rc, xp, xc, yp, yc, par


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
    outside `active` get q = 0: floor(x / 2^(16*steps)). The reduction
    runs on every lane and reads no value on the host. Torch ops only (the
    core of K4's plain version, redc_mod)."""
    Lx = x.shape[-1]
    Ld = d_mag.shape[-1]
    _, xm = lb.canonicalize_fast(x)
    if inv is None:
        inv = lb.inv_pow2(d_mag, steps)
    ninv = lb._negate_mag_fast(inv)
    q = lb.mag_mul_plain(lb.resize(xm, steps), ninv, steps)
    if active is not None:
        q = torch.where(active[..., None], q, 0)
    Ly = max(Lx, steps + Ld) + 1
    y = lb.canonicalize_nonneg(lb.resize(xm, Ly) + lb.mag_mul_plain(q, d_mag, Ly))
    return lb.resize(y[..., steps:], Lx)


def redc_mod(x, d_mag, steps: int, active=None, inv=None):
    """K4's plain version: x * 2^(-16*steps) mod d, canonical in [0, d) at
    x's width, for ODD canonical d (Ld <= Lx limbs) and x < 2^(16*steps)
    (then redc_pow16 lands in [0, d] and one subtraction of d finishes).
    Lanes outside `active` get floor(x / 2^(16*steps)) reduced once by d.
    `inv` as for redc_pow16."""
    r = redc_pow16(x, d_mag, steps, active=active, inv=inv)
    _, r = lb.canonicalize_fast(r)
    ge = lb.mag_cmp(r, d_mag) >= 0
    d = lb.resize(d_mag, r.shape[-1])
    return lb.canonicalize_fast(r - torch.where(ge[..., None], d, 0))[1]
