"""Batched extended GCD via Bernstein-Yang divsteps on balanced redundant
limbs (torch port of cofhe_tpu/ops/xgcd2.py), in groups of 30 divsteps.

`xgcd_coeff_g` here is the plain version of the Hopper kernel in
csrc/xgcd_coeff_g.cu (ops/cuda_group.py dispatches between them); the two
compute the same limbs group for group.

What bounded the earlier design: the JAX package groups 13 divsteps,
because |matrix entries| <= 2^13 keeps its int32 products exact on a TPU,
and keeps the Bezout rows ~1.5m-bounded by an f32-estimated quotient
subtraction plus a Montgomery step. On the card each group was then a
chain of ~40-45 dependent warp shuffles (carry passes, value estimates,
broadcasts) for 13 divsteps.

What this schedule does instead:

* Each group simulates STEPS = 30 divsteps on the low 32 bits of f and g
  (limb 0 + limb 1 * 2^16 mod 2^32, exact for redundant limbs). The
  decision of step k is the parity of g after k steps, which the low k + 1
  bits fix, so 30 steps need 31 of the 32 bits. The matrix entries stay
  within 2^30: each row's |u| + |v| at most doubles a step.
* The matrix is applied to f and g with int64 products (|u f_j + v g_j| <
  2^46 on balanced limbs), divided exactly by 2^30 (one limb offset and a
  14-bit shift, `_shr30`), split back to int32 limbs and carried once
  (`_normalize`).
* The Bezout rows (Q, S and, with need_u, P, R) take the safegcd update
  of libsecp256k1 (secp256k1_modinv32_update_de_30; its
  doc/safegcd_implementation.md gives the argument), steered by the rows'
  signs alone, with no value estimate and no quotient: see
  `bezout_update`.

Why the outputs are the JAX package's, limb for limb: the divstep
sequence is the same (delta starts at 1, the same step rule; only the
grouping differs, and each step's decision depends on the low bits
alone). Each row holds its residue times 2^-n mod m after n divsteps
however the steps are grouped, and steps past g = 0 leave f and the f-row
residues (Q, P) as they are (u, v double, the division by 2 undoes it),
so d = |f| and the residues of cg and cu are those of the 13-step
schedule; both are returned canonical. A lane leaves the loop once its g
is zero (here: it is frozen), and `iters` counts its groups: ceil(n / 30)
for the step n at which g reaches 0.
"""

from __future__ import annotations

import torch

from . import limb as lb
from . import rl

STEPS = 30  # divsteps per group; |matrix entries| <= 2^30 fit int32
M30 = (1 << STEPS) - 1
M32 = (1 << 32) - 1
I32 = torch.int32
I64 = torch.int64


def divstep_bound(n: int) -> int:
    """Safegcd divstep bound for n-bit inputs (the JAX package's
    iterations_for_bits before its rounding to a 13-step group)."""
    return (45907 * n + 26313) // 19929 + 1


def groups_for_bits(n: int, steps: int = STEPS) -> int:
    """Groups of `steps` divsteps that cover the bound for n-bit inputs."""
    return -(-divstep_bound(n) // steps)


def low32(x):
    """Value mod 2^32 of (..., L) redundant limbs, as int64 in [0, 2^32)."""
    lo = x[..., 0].to(I64)
    if x.shape[-1] > 1:
        lo = lo + (x[..., 1].to(I64) << 16)
    return lo & M32


def divstep_group(delta, flo, glo):
    """STEPS divsteps on the low 32 bits of f and g (int64 in [0, 2^32)).
    Returns (delta', uv, qr) with int64 rows uv = [u, v], qr = [q, r] of
    shape (..., 2): [f'; g'] = [[u, v], [q, r]] @ [f; g] / 2^STEPS.
    |u| + |v| <= 2^STEPS and |q| + |r| <= 2^STEPS."""
    uv = torch.zeros(delta.shape + (2,), dtype=I64, device=delta.device)
    qr = torch.zeros_like(uv)
    uv[..., 0] = 1
    qr[..., 1] = 1
    f, g = flo, glo
    for _ in range(STEPS):
        g_odd = g & 1
        swap = (delta > 0) & (g_odd == 1)
        delta = torch.where(swap, 1 - delta, 1 + delta)
        f, g = (torch.where(swap, g, f),
                torch.where(swap, (g - f) >> 1, (g + g_odd * f) >> 1))
        sw = swap[..., None]
        uv, qr = (torch.where(sw, 2 * qr, 2 * uv),
                  torch.where(sw, qr - uv, qr + g_odd[..., None] * uv))
    return delta, uv, qr


def _shr30(s):
    """Exact s / 2^30 of int64 limb sums whose value is a multiple of 2^30:
    limb 0 is then a multiple of 2^16 and folds into limb 1 (the limb
    offset), and limb 1 + limb 0 / 2^16 a multiple of 2^14 (the shift)."""
    s1 = lb._shift_down(s, 1)
    s1[..., 0] += s[..., 0] >> 16
    s2 = lb._shift_down(s, 2)
    return (s1 >> 14) + ((s2 & 0x3FFF) << 2)


def _normalize(s):
    """int64 sums (|s| < 2^48) -> balanced int32 limbs of s / 2^30. The
    quotient's limbs are below 2^34 in magnitude: each below the top splits
    into its low 16 bits and the rest, which moves one limb up; the top
    limb keeps its whole value (it is 0 unless the row has one limb). One
    carry pass leaves the limbs below the top in [-2^15 - 2, 2^15 + 3)."""
    y = _shr30(s)
    lo = y & 0xFFFF
    lo[..., -1] = y[..., -1]
    return rl.carry_pass((lo + lb._shift_up(y >> 16, 1)).to(I32))


def apply_fg(uv, qr, f, g):
    """(f, g) <- M (f, g) / 2^30 on balanced limbs."""
    f64, g64 = f.to(I64), g.to(I64)
    return (_normalize(uv[..., :1] * f64 + uv[..., 1:] * g64),
            _normalize(qr[..., :1] * f64 + qr[..., 1:] * g64))


def row_sign(x):
    """(...,) bool: value < 0, for balanced limbs (|each limb below the
    top| < 2^16 - 1, so the top nonzero limb carries the sign)."""
    L = x.shape[-1]
    idx = lb._arange(L, x.device)
    top = torch.where(x != 0, idx, 0).amax(-1)
    return torch.gather(x, -1, top[..., None])[..., 0] < 0


def modinv30(m):
    """m^-1 mod 2^30 for odd m: limb.modinv16 and one more Newton step."""
    y = low32(m) & M30
    x = lb.modinv16(m[..., 0]).to(I64)
    return (x * (2 - ((y * x) & M30))) & M30


def bezout_update(uv, qr, X, Y, m, minv):
    """The safegcd update of one pair of Bezout rows (libsecp256k1's
    secp256k1_modinv32_update_de_30) on balanced limbs:

        X' = (u X + v Y + mx m) / 2^30,  Y' = (q X + r Y + my m) / 2^30,

    with mx = (u if X < 0) + (v if Y < 0) less (m^-1 (u X + v Y) + mx) mod
    2^30, which makes the numerator a multiple of 2^30 (my likewise), so
    X' ≡ (u X + v Y) 2^-30 (mod m). Range: for odd m, X, Y in (-2m, m]
    and |u| + |v| <= 2^30, adding m to a negative row puts it in (-m, m],
    so |u X + v Y + m (u [X<0] + v [Y<0])| <= 2^30 m; the correction
    subtracts k m with 0 <= k < 2^30; the quotient by 2^30 lies in
    (-2m, m] again. Limbs: |u X_j + v Y_j| < 2^30 (2^15 + 3) and |mx m_j| <
    2^31 2^16, so the sums stay below 2^48."""
    Xn, Yn = row_sign(X), row_sign(Y)
    Xlo, Ylo = low32(X), low32(Y)

    def corr(c):
        mc = torch.where(Xn, c[..., 0], 0) + torch.where(Yn, c[..., 1], 0)
        cd = (c[..., 0] * Xlo + c[..., 1] * Ylo) & M30
        return mc - ((minv * cd + mc) & M30)

    X64, Y64, m64 = X.to(I64), Y.to(I64), m.to(I64)
    md, me = corr(uv), corr(qr)
    return (_normalize(uv[..., :1] * X64 + uv[..., 1:] * Y64 + md[..., None] * m64),
            _normalize(qr[..., :1] * X64 + qr[..., 1:] * Y64 + me[..., None] * m64))


def xgcd_coeff_g(f_mag, g_mag, m_mag, nbits: int, need_u: bool = False,
                 iters=None):
    """gcd of (f, g) with f ODD, plus the Bezout coefficient of g0 mod m.

    CONTRACT: m divides f0 (so m is odd) and is canonical. Returns
    canonical (d, cg[, cu]) of f's width with cg * g0 ≡ d (mod m),
    0 <= cg < m; with need_u also cu such that cu * f0 + cg * g0 ≡ d
    (mod m). nbits bounds max(bits(f), bits(g)) and only caps the loop at
    groups_for_bits(nbits) groups: a lane leaves it once its g is zero.
    `iters`, if given, is a (B,) int32 tensor that receives each lane's
    number of groups."""
    L = f_mag.shape[-1]
    m = lb.resize(m_mag, L)
    minv = modinv30(m)
    groups = groups_for_bits(nbits)

    f = rl.carry_pass(f_mag.to(I32))
    g = rl.carry_pass(g_mag.to(I32))
    delta = torch.ones(f.shape[:-1], dtype=I64, device=f.device)
    one0 = lb.one_limbs(f.shape[:-1], L, f.device)
    Q, S = torch.zeros_like(f), one0
    P, R = one0, torch.zeros_like(f)
    count = torch.zeros(f.shape[:-1], dtype=I32, device=f.device)

    k = 0
    while k < groups:
        live = (g != 0).any(-1)
        if not bool(live.any()):
            break
        delta2, uv, qr = divstep_group(delta, low32(f), low32(g))
        rows = [*apply_fg(uv, qr, f, g), *bezout_update(uv, qr, Q, S, m, minv)]
        if need_u:
            rows += bezout_update(uv, qr, P, R, m, minv)
        lv = live[..., None]
        f, g, Q, S = (torch.where(lv, new, old) for new, old in zip(rows, (f, g, Q, S)))
        if need_u:
            P, R = torch.where(lv, rows[4], P), torch.where(lv, rows[5], R)
        delta = torch.where(live, delta2, delta)
        count += live.to(I32)
        k += 1
    if iters is not None:
        iters.copy_(count)

    sf, d = lb.canonicalize_fast(f)

    def into_range(x):
        """Row in (-2m, m] -> canonical sign(f) * x mod m."""
        sX, mX = lb.canonicalize_fast(x)
        sX = torch.where(sf < 0, -sX, sX)  # normalize to +d
        return rl.exact_mod_tail(sX[..., None] * mX, m)

    cg = into_range(Q)
    if need_u:
        return d, cg, into_range(P)
    return d, cg
