"""v2 batched Gauss composition + reduction on balanced redundant limbs
(torch port of cofhe_tpu/ops/forms2.py).

The algebra and the widths are the JAX package's:

* identity fast path: lanes whose a == 1 are substituted by two different
  fixed non-identity forms (h on one side, h^2 on the other) and the result
  is selected afterwards;
* first gcd d1 = gcd(a2, a1) with the a1-coefficient mod a2, two-tier in
  width (narrow Lxn pass, full-width pass for the rare lanes that do not
  fit);
* second gcd g = gcd(d1, |s|) via Montgomery REDC at width 8, with a
  full-width rare path, and xi from the exact identity
  xi = (g - eta0*|s|) / d1;
* mu = [u*(b2-b1) - 2*w*c1] mod 2*m2 with one top-down reduction;
* reduction: estimate-driven rho-descent (grouped or per-quotient) and the
  exact tail `forms.reduce_batch`.

Every `xgcd_coeff_g`, `mod_topdown` and grouped-rho loop goes through the
dispatchers of ops/cuda_group.py: on a CUDA tensor they launch the Hopper
kernels, on a CPU tensor they run the plain torch versions. Reduced forms
are unique, so the outputs equal the JAX package's and the pure-Python
oracle's bit for bit.

The rho loops in torch ops test their exit condition on the host every
`SYNC_EVERY` iterations; their bodies are fixed points on finished lanes,
and the JAX iteration caps are kept.
"""

from __future__ import annotations

import torch

from . import cuda_group
from . import limb as lb
from . import rl
from .forms import BForm, bform_broadcast, bform_from_numpy, bform_select, \
    reduce_batch, rotate_to_odd

I32 = torch.int32
F32 = torch.float32

# host syncs of the torch-op loops: one exit test every SYNC_EVERY iterations
SYNC_EVERY = 4


def _renorm_est(m, t):
    """Renormalize a (mant f32, top int32) estimate so |mant| lands back
    in ~[1, 2^16) (zero mant passes through)."""
    sh = (rl.log2f_i(m) >> 4).clamp(-4, 4)
    z = m == 0.0
    return (torch.where(z, m, m * rl.pow2f(-16 * sh)),
            torch.where(z, t, t + sh))


def _flags(ma, ta, mb, tb, mc, tc):
    """(need_norm, need_rho) of the rho-descent from value estimates."""
    bitsA = rl.bits_est(ma, ta)
    bitsB = rl.bits_est(mb, tb)
    bitsC = rl.bits_est(mc, tc)
    raw_norm = bitsB > bitsA + 0.25
    # quotients above ~25 bits fall to the exact tail
    freak = bitsB - bitsA > 25.0
    need_rho = ~raw_norm & (bitsC < bitsA - 0.25)
    return raw_norm & ~freak, need_rho


def _c_est(ma, ta, mb, tb, dD_mant: float, dD_top: int):
    """(mant, top) of c = (b^2 + |Delta|) / (4a) from the estimates of a
    and b via the discriminant invariant (the direct update
    c' = c + q*(q*a - b) cancels catastrophically, the invariant never)."""
    t2b = 2 * tb
    tbig = t2b.clamp(min=dD_top)
    m1 = (mb * mb) * rl.pow2f((16 * (t2b - tbig)).clamp(-126, 0))
    m2 = dD_mant * rl.pow2f((16 * (dD_top - tbig)).clamp(-126, 0))
    mc = (m1 + m2) / (4.0 * ma).clamp(min=1e-30)
    return _renorm_est(mc, tbig - ta)


def grouped_rho_loop(a_red, b_red, c_red, dD_mant: float, dD_top: int,
                     red_iters: int, iters=None):
    """The grouped rho-descent loop (plain version of K3): simulate up to 3
    normalization/rho quotients per group on (mant, top) scalar estimates,
    accumulating a unimodular M = [[p, q], [r, s]] with entries below 2^12,
    then apply M once to the limb tensors:
        a' = a p^2 + b p r + c r^2
        b' = 2 a p q + b (p s + q r) + 2 c r s
        c' = a q^2 + b q s + c s^2
    with 13+12-bit split coefficients. Inputs must be a genuine form of the
    discriminant |Delta| = dD_mant * 2^(16 dD_top); returns the redundant
    (a, b, c) after at most red_iters groups. Estimate noise can only waste
    a group; the exact tail finishes. `iters`, if given, receives each
    lane's number of groups."""
    sim_steps = 3
    lim = 4096  # 2^12 matrix-entry bound

    def ests(a, b):
        ma, ta = rl.value_est(a)
        mb, tb = rl.value_est(b)
        mc, tc = _c_est(ma, ta, mb, tb, dD_mant, dD_top)
        nn, nr = _flags(ma, ta, mb, tb, mc, tc)
        return ma, ta, mb, tb, nn | nr

    def coefmul(coef, v, v13):
        s = torch.sign(coef)
        u = coef.abs()
        return ((u & 0x1FFF) * s)[..., None] * v \
            + ((u >> 13) * s)[..., None] * v13

    a, b, c = rl.carry2(a_red), rl.carry2(b_red), rl.carry2(c_red)
    ma, ta, mb, tb, lane = ests(a, b)
    count = torch.zeros_like(ta)
    for it in range(red_iters):
        if it % SYNC_EVERY == 0 and not bool(lane.any()):
            break
        count = count + lane.to(I32)
        p = torch.ones_like(ta)
        r = torch.zeros_like(ta)
        qq = torch.zeros_like(ta)
        ss = torch.ones_like(ta)
        sma, sta, smb, stb = ma, ta, mb, tb
        for _ in range(sim_steps):
            mc_e, tc_e = _c_est(sma, sta, smb, stb, dD_mant, dD_top)
            need_norm, need_rho = _flags(sma, sta, smb, stb, mc_e, tc_e)
            act = lane & (need_norm | need_rho)
            do_rho = act & need_rho
            man = torch.where(do_rho, mc_e, sma)
            tan = torch.where(do_rho, tc_e, sta)
            mbn = torch.where(do_rho, -smb, smb)
            # matrix right-multiplied by rho = [[0,-1],[1,0]]
            p2 = torch.where(do_rho, qq, p)
            qq2 = torch.where(do_rho, -p, qq)
            r2 = torch.where(do_rho, ss, r)
            ss2 = torch.where(do_rho, -r, ss)
            # digit q ~ b/2a, clipped to the remaining matrix budget
            ratio = mbn / (2.0 * man).clamp(min=1e-30)
            scale = rl.pow2f((16 * (stb - tan)).clamp(-126, 60))
            col1 = torch.maximum(p2.abs(), r2.abs())
            col2 = torch.maximum(qq2.abs(), ss2.abs())
            qcap = torch.div(lim - col2, col1.clamp(min=1),
                             rounding_mode="floor").to(F32)
            qf = torch.minimum(torch.maximum(torch.round(ratio * scale),
                                             -qcap), qcap)
            qf = torch.where(act, qf, 0.0)
            qi = qf.to(I32)
            # b <- b - 2 q a at b's scale, renormalized
            inv = rl.pow2f((16 * (tan - stb)).clamp(-126, 60))
            smb, stb = _renorm_est(mbn - 2.0 * qf * man * inv, stb)
            sma, sta = man, tan
            p, r = p2, r2
            qq, ss = qq2 - qi * p2, ss2 - qi * r2
        a13 = rl.carry_pass(a << 13)
        b13 = rl.carry_pass(b << 13)
        c13 = rl.carry_pass(c << 13)

        def xform(ca, cb, cc):
            return rl.carry_pass(coefmul(ca, a, a13) + coefmul(cb, b, b13)
                                 + coefmul(cc, c, c13))

        a, b, c = (xform(p * p, p * r, r * r),
                   xform(2 * p * qq, p * ss + qq * r, 2 * r * ss),
                   xform(qq * qq, qq * ss, ss * ss))
        ma, ta, mb, tb, lane = ests(a, b)
    if iters is not None:
        iters.copy_(count)
    return a, b, c


# the wide grouped loop: matrix entries below 2^WIDE_E, up to WIDE_SIM
# simulated quotients a group; the flags' margins 2^(+-0.25) and the freak
# bound 2^25 of the f32 loop, as float64 constants the kernel shares
WIDE_E = 22
WIDE_SIM = 12
UP, DOWN, FREAK = 1.189207115002721, 0.8408964152537145, 33554432.0
F64 = torch.float64


def _scaled_wide(ma, ta, mb, tb, dD_mant: float, dD_top: int):
    """a, b and |Delta| as float64 at a's scale 2^(16 ta), which the group
    keeps: a ~ ma, b ~ sb, |Delta| ~ dp (exponents clamped; a value that
    underflows to 0 is negligible beside the others)."""
    sb = mb * rl.pow2d((16 * (tb - ta)).clamp(-1100, 1000))
    dp = dD_mant * rl.pow2d((16 * (dD_top - 2 * ta)).clamp(-1100, 1000))
    return ma, sb, dp


def _flags_wide(sa, sb, dp):
    """(need_norm, need_rho, b^2 + |Delta|) by products, no logarithm and
    no division: normalize when |b| > 2^0.25 a unless |b| > 2^25 a (a
    freak quotient, left to the exact tail); rho when c = (b^2 + |Delta|)
    / 4a < 2^-0.25 a."""
    ab = sb.abs()
    raw = ab > sa * UP
    num = sb * sb + dp
    need_rho = ~raw & (num < 4.0 * sa * sa * DOWN)
    return raw & ~(ab > sa * FREAK), need_rho, num


def grouped_rho_loop_wide(a_red, b_red, c_red, dD_mant: float, dD_top: int,
                          red_iters: int, iters=None):
    """The wide grouped rho-descent loop (plain version of K3). Per group:
    take float64 estimates of a and b (top four limbs, `rl.value_est_wide`)
    at a's scale, and simulate normalization/rho quotients on them (c from
    the invariant c = (b^2 + |Delta|) / 4a, one division on a rho step and
    one for the quotient) until the unimodular M = [[p, q], [r, s]] would
    pass its 2^WIDE_E entry budget, the form looks reduced, or WIDE_SIM
    steps; then apply M once with one int64 product per coefficient,
        a' = a p^2 + b p r + c r^2
        b' = 2 a p q + b (p s + q r) + 2 c r s
        c' = a q^2 + b q s + c s^2
    (coefficients below 2^45, balanced limbs below 2^15.01: each three-term
    sum stays below 2^62), spread the sums back into 16-bit limbs and run
    one carry pass. Every scalar step is an IEEE float64 operation that the
    kernel performs in the same order (M's entries are exact float64
    integers), so kernel and plain version give the same limbs. Estimate
    noise can only waste a group; quotients above 25 bits fall to the
    exact tail. `iters`, if given, receives each lane's number of groups."""
    lim = float(1 << WIDE_E)

    def ests(a, b):
        ma, ta = rl.value_est_wide(a)
        mb, tb = rl.value_est_wide(b)
        sa, sb, dp = _scaled_wide(ma, ta, mb, tb, dD_mant, dD_top)
        nn, nr, _ = _flags_wide(sa, sb, dp)
        return (sa, sb, dp), nn | nr

    a, b, c = rl.carry2(a_red), rl.carry2(b_red), rl.carry2(c_red)
    (sa, sb, dp), lane = ests(a, b)
    count = torch.zeros_like(lane, dtype=torch.int64)
    for _ in range(red_iters):
        if not bool(lane.any()):
            break
        count = count + lane.long()
        one, zero = torch.ones_like(sa), torch.zeros_like(sa)
        p, r, qq, ss = one, zero, zero, one
        live = lane
        for _ in range(WIDE_SIM):
            if not bool(live.any()):
                break
            need_norm, need_rho, num = _flags_wide(sa, sb, dp)
            act = live & (need_norm | need_rho)
            do_rho = act & need_rho
            # rho: (a, b, c) -> (c, -b, a), M right-multiplied by [[0,-1],[1,0]]
            man = torch.where(do_rho, num / (4.0 * sa).clamp(min=1e-300), sa)
            mbn = torch.where(do_rho, -sb, sb)
            p2, qq2 = torch.where(do_rho, qq, p), torch.where(do_rho, -p, qq)
            r2, ss2 = torch.where(do_rho, ss, r), torch.where(do_rho, -r, ss)
            # q = round(b / 2a) of the form after the rho, from sa and sb
            # (-2ab / (b^2 + |Delta|) after a rho, so that the kernel's two
            # divisions run side by side); past the budget it is clipped to
            # what the budget leaves (the division runs only then in the
            # kernel)
            qreal = torch.where(do_rho, -2.0 * sa * sb / num.clamp(min=1e-300),
                                sb / (2.0 * sa).clamp(min=1e-300))
            qround = torch.round(qreal)
            col1 = torch.maximum(p2.abs(), r2.abs()).clamp(min=1.0)
            col2 = torch.maximum(qq2.abs(), ss2.abs())
            spent = ~(qround.abs() * col1 + col2 <= lim)
            qcap = torch.floor((lim - col2) / col1)
            qf = torch.where(spent, torch.minimum(torch.maximum(qround, -qcap), qcap),
                             qround)
            nb = mbn - 2.0 * qf * man
            sa, sb = torch.where(act, man, sa), torch.where(act, nb, sb)
            p, r = torch.where(act, p2, p), torch.where(act, r2, r)
            qq = torch.where(act, qq2 - qf * p2, qq)
            ss = torch.where(act, ss2 - qf * r2, ss)
            live = act & ~spent
        p, r, qq, ss = p.long(), r.long(), qq.long(), ss.long()
        al, bl, cl = a.long(), b.long(), c.long()

        def xform(ca, cb, cc, old):
            s = ca[..., None] * al + cb[..., None] * bl + cc[..., None] * cl
            # finished lanes keep their limbs (the kernel's warp has left)
            return torch.where(lane[..., None], rl.carry_pass(rl.spread_carry(s, 4)), old)

        a, b, c = (xform(p * p, p * r, r * r, a),
                   xform(2 * p * qq, p * ss + qq * r, 2 * r * ss, b),
                   xform(qq * qq, qq * ss, ss * ss, c))
        (sa, sb, dp), on = ests(a, b)
        lane = lane & on
    if iters is not None:
        iters.copy_(count)
    return a, b, c


def _one_limbs_like(x, L: int):
    return lb.one_limbs(x.shape[:-1], L, x.device)


class CGCtx:
    """Static widths for one discriminant."""

    @staticmethod
    def widths_for_disc_bits(disc_bits: int):
        L = (disc_bits + 16 * 6) // 16 + 1
        L = ((L + 7) // 8) * 8
        Lh = (disc_bits // 2 + 64) // 16 + 1
        Lh = ((Lh + 7) // 8) * 8
        return L, Lh


def _r8(limbs: int) -> int:
    return ((limbs + 7) // 8) * 8


class CG:
    """Per-discriminant kernel family on one torch device: the widths, the
    constant |Delta|/4 and the two substitute forms h, h^2 of the identity
    fast path."""

    def __init__(self, disc_bits: int, delta4: torch.Tensor, h: BForm,
                 h2: BForm):
        self.device = delta4.device
        self.disc_bits = disc_bits
        L, Lh = CGCtx.widths_for_disc_bits(disc_bits)
        self.L, self.Lh = L, Lh
        self.delta4 = delta4  # (2L,) magnitude of |Delta|/4
        # |Delta| as a (mant, top) estimate for the grouped-rho sim
        d4int = sum(int(v) << (16 * i) for i, v in enumerate(delta4.tolist()))
        dD = 4 * d4int
        tD = max((dD.bit_length() - 1) // 16, 0)
        sh = max(dD.bit_length() - 48, 0)
        self.dD_mant = float(dD >> sh) * (2.0 ** (sh - 16 * tD))
        self.dD_top = int(tD)
        self.h, self.h2 = h, h2
        self.xgcd_nbits = disc_bits + 32
        self.mu_iters = (2 * 16 * L) // 13 + 24
        self.red_iters = (2 * disc_bits) // 13 + 96
        # worst-case intermediate widths (see the JAX package's CG):
        # u = xi*beta <= 3D/2 bits, u*(b2-b1) <= 2D+2 bits, b3/2 <= D bits
        self.Lu = _r8((3 * disc_bits // 2 + 48 + 15) // 16)
        self.Lm = max(_r8((2 * disc_bits + 34 + 15) // 16), L + 8)
        self.Lsq = min(_r8((disc_bits + 19 + 15) // 16), L)
        # narrow width of the first gcd (rotated-in c2 exceeds it only with
        # probability ~2^-400 for random class-group elements)
        self.Lxn = min(_r8(Lh + 16), L)

    @classmethod
    def from_arrays(cls, disc_bits: int, delta4, h_rows, h2_rows,
                    device) -> "CG":
        """CG from the numpy arrays a JAX `CG` holds: `delta4` (2L,) and
        the rows (a, b_sign, b, c) of h and h^2."""
        d4 = torch.as_tensor(delta4).to(device=device, dtype=I32)
        return cls(disc_bits, d4, bform_from_numpy(*h_rows, device),
                   bform_from_numpy(*h2_rows, device))

    # ------------------------------------------------------------ helpers
    @staticmethod
    def _is_one(mag):
        return (mag[..., 0] == 1) & (mag.sum(-1) == 1)

    # ------------------------------------------------------------- reduce
    def reduce2(self, a_red, b_red, c_red, grouped: bool = True) -> BForm:
        """Reduction front-end: the grouped rho-descent or the per-quotient
        loop, then the exact tail. Inputs must be a genuine form of this
        discriminant (the grouped sim derives c from b^2 - 4ac = Delta)."""
        if grouped:
            return self.reduce2_grouped(a_red, b_red, c_red)
        return self.reduce2_iter(a_red, b_red, c_red)

    def _tail(self, a, b, c) -> BForm:
        _, am = lb.canonicalize_fast(a)
        sb, bm = lb.canonicalize_fast(b)
        _, cm = lb.canonicalize_fast(c)
        return reduce_batch(BForm(am, sb, bm, cm), self.disc_bits // 4 + 64)

    def reduce2_grouped(self, a_red, b_red, c_red) -> BForm:
        """Grouped rho-descent (`grouped_rho_loop_wide`, K3 on the card), then
        the exact tail."""
        return self._tail(*cuda_group.reduce2_grouped_loop(
            a_red, b_red, c_red, self.dD_mant, self.dD_top, self.red_iters))

    def reduce2_iter(self, a_red, b_red, c_red) -> BForm:
        """Estimate-driven rho-descent, one quotient per iteration (|q| up
        to 2^27, applied with a 14+14 split); returns a reduced canonical
        BForm. a_red, c_red positive redundant, b_red signed redundant."""

        a, b, c = rl.carry2(a_red), rl.carry2(b_red), rl.carry2(c_red)
        ma, ta = rl.value_est(a)
        mb, tb = rl.value_est(b)
        mc, tc = rl.value_est(c)
        need_norm, need_rho = _flags(ma, ta, mb, tb, mc, tc)
        for it in range(self.red_iters):
            active = need_norm | need_rho
            if it % SYNC_EVERY == 0 and not bool(active.any()):
                break
            rho = need_rho[..., None]
            a, c = torch.where(rho, c, a), torch.where(rho, a, c)
            bn = torch.where(rho, -b, b)
            man = torch.where(need_rho, mc, ma)
            tan = torch.where(need_rho, tc, ta)
            mbn = torch.where(need_rho, -mb, mb)
            ratio = mbn / (2.0 * man).clamp(min=1e-30)
            scale = rl.pow2f((16 * (tb - tan)).clamp(-126, 29))
            qd = torch.round(ratio * scale).clamp(-134217000.0, 134217000.0)
            qd = torch.where(active, qd.to(I32), 0)
            a14 = rl.carry_pass(a << 14)
            s = torch.sign(qd)
            aq_ = qd.abs()
            lo = ((aq_ & 0x3FFF) * s)[..., None]
            hi = ((aq_ >> 14) * s)[..., None]
            aq = rl.carry_pass(rl.carry_pass(lo * a) + rl.carry_pass(hi * a14))
            b = rl.carry_pass(bn - 2 * aq)
            t = rl.carry_pass(aq - bn)
            t14 = rl.carry_pass(t << 14)
            c = rl.carry_pass(c + rl.carry_pass(lo * t)
                              + rl.carry_pass(hi * t14))
            ma, ta = man, tan
            mb, tb = rl.value_est(b)
            mc, tc = rl.value_est(c)
            need_norm, need_rho = _flags(ma, ta, mb, tb, mc, tc)
        return self._tail(a, b, c)

    # ------------------------------------------------------------ compose
    def compose2(self, F1: BForm, F2: BForm, grouped: bool = True) -> BForm:
        a3, b3s, b3m, c3, id1, id2 = self.compose2_unreduced(F1, F2)
        out = self.reduce2(a3, b3s[..., None] * b3m, c3, grouped=grouped)
        # identity selects (both identities: F2 is the identity, so the
        # first select already returns it)
        out = bform_select(id2 & ~id1, F1, out)
        return bform_select(id1, F2, out)

    def nudupl2(self, F: BForm, grouped: bool = True) -> BForm:
        return self.compose2(F, F, grouped=grouped)

    def _redc_mod(self, x, d, active, inv):
        """x * 2^(-16 Lh) mod d, canonical in [0, d), for odd d with
        inv = d^-1 mod 2^(16 Lh)."""
        r = rl.redc_pow16(x, d, steps=self.Lh, active=active, inv=inv)
        _, r = lb.canonicalize_fast(r)
        ge = lb.mag_cmp(r, d) >= 0
        return lb.canonicalize_fast(r - torch.where(ge[..., None], d, 0))[1]

    def compose2_unreduced(self, F1: BForm, F2: BForm):
        """Everything before the reduction: the unreduced composed
        (a3, b3s, b3m, c3) and the identity masks (id1, id2)."""
        L, Lh = self.L, self.Lh
        B = F1.a.shape[0]

        id1 = self._is_one(F1.a)
        id2 = self._is_one(F2.a)
        some_id = id1 | id2
        F1b = bform_select(some_id, bform_broadcast(self.h, B), F1)
        F2b = bform_select(some_id, bform_broadcast(self.h2, B), F2)

        # order so a1 <= a2, rotate F2 odd (then a1 * a2_rot <= ~|Delta|)
        swap = lb.mag_cmp(F1b.a, F2b.a) > 0
        F1n = bform_select(swap, F2b, F1b)
        F2n = rotate_to_odd(bform_select(swap, F1b, F2b))
        a1, b1s, b1m, c1 = F1n
        a2, b2s, b2m, c2 = F2n

        # s = (b1 + b2)/2 ; dd = b2 - b1   (b's of reduced forms fit Lh)
        b1h = lb.resize(b1m, Lh)
        b2h = lb.resize(b2m, Lh)
        ss, sm = lb.sm_add((b1s, b1h), (b2s, b2h))
        sm = lb.mag_shr_bits(sm, 1)
        dds, ddm = lb.sm_sub((b2s, b2h), (b1s, b1h))

        # first gcd: d1 = gcd(a2, a1), beta = a1-coefficient mod a2; the
        # narrow pass takes every lane whose operands fit 16*Lxn-32 bits,
        # the full-width pass the rest (its g is 0 on every other lane, so
        # those lanes leave its loop at once)
        if self.Lxn < L:
            NL = self.Lxn
            nb = 16 * NL - 32
            fx = ((lb.mag_bitlen(a2) <= nb) & (lb.mag_bitlen(a1) <= nb))[..., None]
            a2_n = torch.where(fx, a2[..., :NL], _one_limbs_like(a2, NL))
            a1_n = torch.where(fx, a1[..., :NL], 0)
            d1_n, beta_n = cuda_group.xgcd_coeff_g(a2_n, a1_n, a2_n, nb + 16)
            a2_w = torch.where(fx, _one_limbs_like(a2, L), a2)
            a1_w = torch.where(fx, 0, a1)
            d1_w, beta_w = cuda_group.xgcd_coeff_g(a2_w, a1_w, a2_w,
                                                   self.xgcd_nbits)
            d1 = torch.where(fx, lb.resize(d1_n, L), d1_w)
            beta = torch.where(fx, lb.resize(beta_n, L), beta_w)
        else:
            d1, beta = cuda_group.xgcd_coeff_g(a2.contiguous(), a1.contiguous(),
                                               a2.contiguous(), self.xgcd_nbits)

        # second gcd: g = gcd(d1, |s|), eta0 in [0, d1) with
        # eta0 * |s| ≡ g (mod d1). Width 8 when d1 < 2^120 ...
        fits8 = lb.mag_bitlen(d1) <= 120
        one8 = _one_limbs_like(d1, 8)
        d1_8 = torch.where(fits8[..., None], d1[..., :8], one8)
        # one 2-adic inverse of d1 serves both REDC pipelines and xi below
        # (d1 is odd: it divides the odd a2)
        inv_d1 = lb.inv_pow2(d1, Lh)
        one_h = _one_limbs_like(d1, Lh)
        inv8 = torch.where(fits8[..., None], inv_d1, one_h)
        rp_m = self._redc_mod(lb.resize(sm, Lh), lb.resize(d1_8, Lh), fits8,
                              inv8)
        g8, eta8 = cuda_group.xgcd_coeff_g(d1_8, rp_m[..., :8].contiguous(),
                                           d1_8, 136)
        # rp carries 2^(-16 Lh): eta8 * rp ≡ g, so the same scale removal
        # applies to eta8
        eta0_8 = self._redc_mod(eta8, d1_8, fits8, inv8)

        # ... and the same pipeline at width Lh on the rare rest (its loops
        # do no work when no lane needs it)
        rare = ~fits8 & ~some_id
        d1h = torch.where(rare[..., None], lb.resize(d1, Lh),
                          lb.resize(one8, Lh))
        invF = torch.where(rare[..., None], inv_d1, one_h)
        rpF_m = self._redc_mod(lb.resize(sm, Lh), d1h, rare, invF)
        gF, etaF = cuda_group.xgcd_coeff_g(
            d1h, torch.where(rare[..., None], rpF_m, 0), d1h, 16 * Lh)
        eta0F = self._redc_mod(etaF, d1h, rare, invF)

        g = torch.where(fits8[..., None], lb.resize(g8, Lh), lb.resize(gF, Lh))
        eta0 = torch.where(fits8[..., None], lb.resize(eta0_8, Lh), eta0F)

        # xi = (g - eta0*|s|) / d1 exactly (integer identity); |xi| <= |s|
        prod_es = lb.mag_mul(eta0, sm, L)
        ones = torch.ones_like(ss)
        xi_s, tm = lb.sm_sub((ones, lb.resize(g, L)), (ones, prod_es))
        xi = lb.mag_divexact_odd(tm, d1, Lh, inv=inv_d1)

        # u = xi * beta ; mu_num = u*(b2-b1) - 2*sign(s)*eta0*c1
        Lu, Lm = self.Lu, self.Lm
        u = lb.mag_mul(xi, beta, Lu)
        t1 = lb.mag_mul(u, ddm, Lm)
        t2 = lb.mag_mul(eta0, c1, L)
        mu_red = ((xi_s * dds)[..., None] * t1
                  - 2 * (ss[..., None] * lb.resize(t2, Lm)))

        # m2 = a2/g, a1g = a1/g (g odd: divides odd a2 via d1)
        inv_g = lb.inv_pow2(g, L)
        m2 = lb.mag_divexact_odd(a2, g, L, inv=inv_g)
        a1g = lb.mag_divexact_odd(a1, g, Lh, inv=inv_g)
        m2x2 = lb.mag_shl_bits(m2, 1, L)
        mu = lb.resize(cuda_group.mod_topdown(mu_red, m2x2, self.mu_iters), L)

        # a3 = a1g*m2 ; b3 = b1 + a1g*mu ; c3 = ((b3/2)^2 + |D|/4)/a3
        a3 = lb.mag_mul(a1g, m2, L)
        t = lb.mag_mul(a1g, mu, L)
        b3s, b3m = lb.sm_add((b1s, b1m), (torch.ones_like(b1s), t))
        b3h = lb.resize(lb.mag_shr_bits(b3m, 1), self.Lsq)
        sq = lb.mag_mul(b3h, b3h, Lm)
        _, csum = lb.canonicalize_fast(lb.resize(sq, Lm)
                                       + lb.resize(self.delta4, Lm))
        e = lb.mag_v2(a3)
        a3_odd = lb.mag_shr_bits_dyn(a3, e)
        csum_sh = lb.mag_shr_bits_dyn(csum, e.clamp(max=16 * Lm - 1))
        c3 = lb.mag_divexact_odd(csum_sh, lb.resize(a3_odd, Lm), L)
        return a3, b3s, b3m, c3, id1, id2
