"""Batched extended GCD via Bernstein-Yang divsteps on balanced redundant
limbs (torch port of cofhe_tpu/ops/xgcd2.py).

`xgcd_coeff_g` here is the plain version of the Hopper kernel in
csrc/xgcd_coeff_g.cu (ops/cuda_group.py dispatches between them): 13
divsteps per group simulated on the low bits of limb 0, the 2x2 matrix
applied to the full-width rows, and the Bezout column kept ~1.5m-bounded by
an f32-estimated quotient subtraction plus a fused Montgomery step.
"""

from __future__ import annotations

import torch

from . import limb as lb
from . import rl

W = 13  # divsteps per group; |matrix entries| <= 2^13 keeps int32 exact
MASK_W = (1 << W) - 1
I32 = torch.int32


def iterations_for_bits(n: int) -> int:
    """Safegcd divstep bound for n-bit inputs, rounded up to a group."""
    it = (45907 * n + 26313) // 19929 + 1
    return ((it + W - 1) // W) * W


def _divstep_group(delta, f0l, g0l):
    """Simulate W divsteps on int32 low bits. Returns (delta', u, v, q, r)
    with [f'; g'] = [[u, v], [q, r]] @ [f; g] / 2^W."""
    u = torch.ones_like(delta)
    v = torch.zeros_like(delta)
    q = torch.zeros_like(delta)
    r = torch.ones_like(delta)
    f, g = f0l, g0l
    for _ in range(W):
        g_odd = g & 1
        swap = (delta > 0) & (g_odd == 1)
        delta = torch.where(swap, 1 - delta, 1 + delta)
        f, g = (torch.where(swap, g, f),
                torch.where(swap, (g - f) >> 1, (g + g_odd * f) >> 1))
        u, v, q, r = (torch.where(swap, 2 * q, 2 * u),
                      torch.where(swap, 2 * r, 2 * v),
                      torch.where(swap, q - u, q + g_odd * u),
                      torch.where(swap, r - v, r + g_odd * v))
    return delta, u, v, q, r


def _shr_w(x):
    """Exact division by 2^W on redundant limbs whose value is ≡ 0 mod 2^W."""
    return (x >> W) + (lb._shift_down(x & MASK_W) << (16 - W))


def _submul0(x, qd, m, m14):
    """x - qd*m for |qd| < 2^28 (14+14 split), no limb shift."""
    s = torch.sign(qd)
    a = qd.abs()
    lo = (a & 0x3FFF) * s
    hi = (a >> 14) * s
    return x - rl.carry_pass(lo[..., None] * m) - rl.carry_pass(hi[..., None] * m14)


def xgcd_coeff_g(f_mag, g_mag, m_mag, nbits: int, need_u: bool = False):
    """gcd of (f, g) with f ODD, plus the Bezout coefficient of g0 mod m.

    CONTRACT: m divides f0. Returns canonical (d, cg[, cu]) of f's width
    with cg * g0 ≡ d (mod m), 0 <= cg < m; with need_u also cu such that
    cu * f0 + cg * g0 ≡ d (mod m). nbits bounds max(bits(f), bits(g)) and
    only caps the loop: it exits once every g is zero."""
    L = f_mag.shape[-1]
    m = lb.resize(m_mag, L)
    _, m14 = lb.canonicalize_fast(m << 14)
    minv_w = (-lb.modinv16(m[..., 0])) & MASK_W
    mant_m, top_m = rl.value_est(m)
    groups = iterations_for_bits(nbits) // W

    f = rl.carry_pass(f_mag.to(I32))
    g = rl.carry_pass(g_mag.to(I32))
    delta = torch.ones(f.shape[:-1], dtype=I32, device=f.device)
    one0 = lb.one_limbs(f.shape[:-1], L, f.device)
    Q, S = torch.zeros_like(f), one0
    P, R = one0, torch.zeros_like(f)

    def reduce_row(x):
        """(matrix-applied accumulator) * 2^-W (mod m), kept ~1.5m-bounded."""
        x = rl.carry2(x)
        mant_x, top_x = rl.value_est(x)
        ratio = mant_x / mant_m.clamp(min=1e-30)
        scale = rl.pow2f((16 * (top_x - top_m)).clamp(-126, 30))
        qd = torch.round(ratio * scale).clamp(-98303.0, 98303.0).to(I32)
        x = _submul0(x, qd, m, m14)
        t = ((x[..., 0] & MASK_W) * minv_w) & MASK_W
        return rl.carry_pass(_shr_w(x + t[..., None] * m))

    k = 0
    # extra groups past g == 0 are exact identities (u = 2^W, shr_w undoes
    # it; reduce_row only re-represents Q mod m)
    while k < groups and bool((g != 0).any()):
        delta, u, v, q, r = _divstep_group(delta, f[..., 0], g[..., 0])
        u_, v_, q_, r_ = u[..., None], v[..., None], q[..., None], r[..., None]
        f, g = (rl.carry_pass(_shr_w(u_ * f + v_ * g)),
                rl.carry_pass(_shr_w(q_ * f + r_ * g)))
        Q, S = reduce_row(u_ * Q + v_ * S), reduce_row(q_ * Q + r_ * S)
        if need_u:
            P, R = reduce_row(u_ * P + v_ * R), reduce_row(q_ * P + r_ * R)
        k += 1

    sf, d = lb.canonicalize_fast(f)

    def into_range(x):
        sX, mX = lb.canonicalize_fast(x)
        sX = torch.where(sf < 0, -sX, sX)  # normalize to +d
        return rl.exact_mod_tail(sX[..., None] * mX, m)

    cg = into_range(Q)
    if need_u:
        return d, cg, into_range(P)
    return d, cg
