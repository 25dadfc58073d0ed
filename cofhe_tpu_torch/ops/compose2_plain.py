"""compose2's plain kernel versions: the torch code a CPU tensor runs
where the card launches K3 (`grouped_rho_loop_wide`), K6b
(`compose2_prologue_plain`, with the first gcd's operands,
`first_gcd_operands`), K6c (`gcd_bridge_plain`), K6d (`gcd2_merge_plain`)
and K6e (`c3_operands_plain`). ops/cuda_group.py dispatches to them, and
ops/forms2.py's CG calls the dispatchers; this module imports neither.
The tests hold each against the JAX code it replaces.
"""

from __future__ import annotations

import torch

from . import limb as lb
from . import rl
from .forms import BForm, bform_broadcast, bform_select, rotate_to_odd


# the wide grouped loop: matrix entries below 2^WIDE_E, up to WIDE_SIM
# simulated quotients a group; the flags' margins 2^(+-0.25) and the freak
# bound 2^25 of the f32 loop, as float64 constants the kernel shares
WIDE_E = 22
WIDE_SIM = 12
UP, DOWN, FREAK = 1.189207115002721, 0.8408964152537145, 33554432.0


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


def compose2_prologue_plain(F1: BForm, F2: BForm, h: BForm, h2: BForm, Lh: int,
                            Lxn: int | None = None):
    """compose2's prologue in torch ops (plain version of K6b, which
    CG.compose2_prologue dispatches): the identity masks, h / h^2 on the
    lanes where either operand is the identity, the swap to a1 <= a2, F2
    rotated odd, s = (b1 + b2)/2 and dd = b2 - b1 on Lh limbs; with a
    narrow width Lxn below the forms' L, the first gcd's operands after
    them (first_gcd_operands)."""
    B = F1.a.shape[0]

    id1 = _is_one(F1.a)
    id2 = _is_one(F2.a)
    some_id = id1 | id2
    F1b = bform_select(some_id, bform_broadcast(h, B), F1)
    F2b = bform_select(some_id, bform_broadcast(h2, B), F2)

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
    out = (a1, b1s, b1m, c1, a2, b2s, b2m, c2, ss, sm, dds, ddm, id1, id2)
    if Lxn is None or Lxn >= a1.shape[-1]:
        return out
    return out + first_gcd_operands(a1, a2, Lxn)


def first_gcd_operands(a1, a2, Lxn: int):
    """The first gcd's operands in torch ops (K6b writes them beside the
    prologue's outputs): fx, whether both a's fit nb = 16 Lxn - 32 bits,
    and the rows of the narrow pass at Lxn limbs (a2, a1 where fx, else
    1 and 0) and of the full-width pass (1 and 0 where fx, else a2, a1)."""
    nb = 16 * Lxn - 32
    fx = (lb.mag_bitlen(a2) <= nb) & (lb.mag_bitlen(a1) <= nb)
    f = fx[..., None]
    a2_n = torch.where(f, a2[..., :Lxn], _one_limbs_like(a2, Lxn))
    a1_n = torch.where(f, a1[..., :Lxn], 0)
    a2_w = torch.where(f, _one_limbs_like(a2, a2.shape[-1]), a2)
    a1_w = torch.where(f, 0, a1)
    return fx, a2_n, a1_n, a2_w, a1_w


def gcd_bridge_plain(d1_w, beta_w, id1, id2, Lh: int, narrow=None):
    """From the first gcd to the second in torch ops (plain version of
    K6c): d1 and beta, the narrow pass's (d1_n, beta_n at Lxn limbs) where
    fx and the full-width pass's (d1_w, beta_w) elsewhere, given `narrow`
    = (d1_n, beta_n, fx), else the full-width pass's alone; fits8 =
    bitlen(d1) <= 120; rare = ~fits8 on lanes with no identity; d1_8 = d1
    cut to 8 limbs where fits8, else 1, also zero-extended to Lh; d1h = d1
    at Lh on the rare lanes, else 1. Returns (d1, beta, fits8, rare, d1_8,
    d1_8 at Lh, d1h)."""
    L = d1_w.shape[-1]
    if narrow is None:
        d1, beta = d1_w, beta_w
    else:
        d1_n, beta_n, fx = narrow
        d1 = torch.where(fx[..., None], lb.resize(d1_n, L), d1_w)
        beta = torch.where(fx[..., None], lb.resize(beta_n, L), beta_w)
    fits8 = lb.mag_bitlen(d1) <= 120
    one8 = _one_limbs_like(d1, 8)
    d1_8 = torch.where(fits8[..., None], d1[..., :8], one8)
    rare = ~fits8 & ~(id1 | id2)
    d1h = torch.where(rare[..., None], lb.resize(d1, Lh), lb.resize(one8, Lh))
    return d1, beta, fits8, rare, d1_8, lb.resize(d1_8, Lh), d1h


def gcd2_merge_plain(g8, eta0_8, gF, eta0F, fits8):
    """The second gcd's two pipelines merged in torch ops (plain version
    of K6d): g and eta0 at gF's width Lh, the width-8 pipeline's (g8,
    eta0_8, zero-extended) where fits8, else the rare pipeline's."""
    Lh = gF.shape[-1]
    f = fits8[..., None]
    g = torch.where(f, lb.resize(g8, Lh), lb.resize(gF, Lh))
    eta0 = torch.where(f, lb.resize(eta0_8, Lh), eta0F)
    return g, eta0


def c3_operands_plain(a3, csum):
    """c3's operands in torch ops (plain version of K6e): with e = v2(a3)
    (16 L for a zero a3), csum >> min(e, 16 Lm - 1) and a3 >> e cut or
    zero-extended to csum's width Lm."""
    Lm = csum.shape[-1]
    e = lb.mag_v2(a3)
    a3_odd = lb.mag_shr_bits_dyn(a3, e)
    csum_sh = lb.mag_shr_bits_dyn(csum, e.clamp(max=16 * Lm - 1))
    return csum_sh, lb.resize(a3_odd, Lm)


def _one_limbs_like(x, L: int):
    return lb.one_limbs(x.shape[:-1], L, x.device)


def _is_one(mag):
    return (mag[..., 0] == 1) & (mag.sum(-1) == 1)
