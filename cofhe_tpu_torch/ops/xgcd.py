"""Batched extended GCD via Bernstein-Yang divsteps with Bezout
coefficients modulo an odd m (torch port of cofhe_tpu/ops/xgcd.py, the
xgcd of the v1 composition `forms.compose_batch` / `nudupl_batch`).

* W = 13 divsteps at a time are simulated on int32 low-bit surrogates,
  giving a 2x2 transition matrix with entries |.| <= 2^13, which keeps
  every int32 product against 16-bit limbs exact.
* The matrix is applied to the full (batch, L) limb rows in redundant form;
  one partial carry pass keeps limbs bounded and the exact /2^13 is
  limb-local (value ≡ 0 mod 2^13 forces limb 0 ≡ 0 mod 2^13).
* The Bezout accumulators stay reduced modulo m: an f32-estimated quotient
  subtraction, then a fused Montgomery step (add t*m to clear 13 low bits,
  then shift), so they never grow beyond ~2m.

The JAX while loop leaves once every g is the all-zero limb row. Here the
host tests that every SYNC_EVERY groups, and a group that runs after it
held is masked to the identity on the device, so the state is the JAX
loop's, limb for limb, whatever the test's period.
"""

from __future__ import annotations

import torch

from .limb import _carry_scan, _limb_at, canonicalize_fast, mag_bitlen, \
    mag_cmp, modinv16, resize
from .rl import SYNC_EVERY

I32 = torch.int32
F32 = torch.float32

W = 13  # divsteps per group; matrix entries bounded by 2^13 keep int32 exact
MASK_W = (1 << W) - 1


def iterations_for_bits(n: int) -> int:
    """Safegcd divstep bound for n-bit inputs, rounded up to a group."""
    it = (45907 * n + 26313) // 19929 + 1
    return ((it + W - 1) // W) * W


def _partial_carry(x):
    """One elementwise carry pass: limbs -> [0, 2^16) plus the floor carry
    of the limb below. The TOP limb keeps its own carry (callers leave >= 2
    guard limbs so it stays tiny)."""
    c = x >> 16
    out = x - (c << 16)
    out[..., 1:] += c[..., :-1]
    out[..., -1] += c[..., -1] << 16
    return out


def _redundant_shr_w(x):
    """Exact division by 2^W on redundant limbs; requires value ≡ 0 (2^W)
    (which forces limb0 ≡ 0 mod 2^W after low bits were cleared)."""
    low = x & MASK_W
    out = x >> W
    out[..., :-1] += low[..., 1:] << (16 - W)
    return out


def _divstep_group(delta, f0l, g0l):
    """Simulate W divsteps on int32 low bits. Returns (delta', u, v, q, r)
    with the scaled integer transition matrix (|entries| <= 2^W):
        [f'; g'] = [[u, v], [q, r]] @ [f; g] / 2^W
    """
    u = torch.ones_like(delta)
    v = torch.zeros_like(delta)
    q = torch.zeros_like(delta)
    r = torch.ones_like(delta)
    f, g = f0l, g0l
    for _ in range(W):
        g_odd = g & 1
        swap = (delta > 0) & (g_odd == 1)
        # swap: (delta, f, g) <- (1 - delta, g, (g - f)/2), rows (2q, 2r), (q - u, r - v)
        # else: (delta, f, g) <- (1 + delta, f, (g + g_odd f)/2), rows (2u, 2v), (q + g_odd u, r + g_odd v)
        delta = torch.where(swap, 1 - delta, 1 + delta)
        f, g = torch.where(swap, g, f), torch.where(swap, (g - f) >> 1,
                                                    (g + g_odd * f) >> 1)
        u, v, q, r = (torch.where(swap, 2 * q, 2 * u),
                      torch.where(swap, 2 * r, 2 * v),
                      torch.where(swap, q - u, q + g_odd * u),
                      torch.where(swap, r - v, r + g_odd * v))
    return delta, u, v, q, r


def _apply_to_fg(u, v, q, r, f, g):
    """(f, g) <- ([u v; q r] @ (f, g)) / 2^W on redundant limbs."""
    uf = u[..., None] * f + v[..., None] * g
    qg = q[..., None] * f + r[..., None] * g
    return (_partial_carry(_redundant_shr_w(uf)),
            _partial_carry(_redundant_shr_w(qg)))


def _approx_quotient(x, m_scaled_f32, m_top):
    """Estimate round(value(x) / m) from the 6-limb window of x's redundant
    limbs around m's top limb (summed in the JAX order). Exact to +-2."""
    L = x.shape[-1]
    acc = torch.zeros(x.shape[:-1], dtype=F32, device=x.device)
    for off in range(-1, 5):  # limbs m_top-1 .. m_top+4
        pos = m_top + off
        valid = (pos >= 0) & (pos < L)
        limb = torch.where(valid, _limb_at(x, pos).to(F32), 0.0)
        acc = acc + limb * (2.0 ** (16 * off))
    return torch.round(acc / m_scaled_f32).to(I32)


def _sub_qm(x, qhat, m, m8):
    """x - qhat * m on redundant limbs; |qhat| < 2^16 handled via 8-bit split
    against m and m<<8."""
    aq = qhat.abs()
    sgn = torch.sign(qhat)
    q_lo = (aq & 0xFF) * sgn
    q_hi = (aq >> 8) * sgn
    return x - q_lo[..., None] * m - q_hi[..., None] * m8


def _apply_bezout_mod(u, v, q, r, P, Q, m, m8, minv_w, m_scaled_f32, m_top):
    """(P, Q) <- ([u v; q r] @ (P, Q)) * 2^-W  (mod m), redundant limbs.

    An estimated quotient subtraction (the matrix product can reach
    2^14 * m), a full canonicalization that pins the limb support near m's
    top limb, then a fused Montgomery step before the exact /2^W shift."""
    def reduce_row(x):
        x = _partial_carry(x)
        qhat = _approx_quotient(x, m_scaled_f32, m_top)
        s, mag = canonicalize_fast(_sub_qm(x, qhat, m, m8))
        x = s[..., None] * mag
        t = ((x[..., 0] & MASK_W) * minv_w) & MASK_W  # x + t*m ≡ 0 (mod 2^W)
        return _partial_carry(_redundant_shr_w(x + t[..., None] * m))

    uP = u[..., None] * P + v[..., None] * Q
    qP = q[..., None] * P + r[..., None] * Q
    return reduce_row(uP), reduce_row(qP)


def xgcd_mod(f_mag, g_mag, m_mag, nbits: int):
    """Extended gcd of (f, g) with f ODD, with Bezout coefficients delivered
    modulo the ODD modulus m.

    Returns (d_mag, u_mag, v_mag) with
        d = gcd(f, g)  (canonical magnitude), and
        u * f + v * g ≡ d (mod m),  0 <= u, v < m.

    nbits: bound on max(bits(f), bits(g)) across the batch.
    """
    L = f_mag.shape[-1]
    m = resize(m_mag, L)
    # -m^-1 mod 2^W for the Montgomery step, m << 8 for the 8-bit split,
    # and an f32 surrogate of m / 2^(16 m_top) for the quotient estimate
    minv_w = (-modinv16(m[..., 0])) & MASK_W
    m8, _ = _carry_scan(m << 8)
    m_top = torch.div(mag_bitlen(m) - 1, 16, rounding_mode="floor").clamp(min=0)
    mt0 = _limb_at(m, m_top).to(F32)
    mt1 = torch.where(m_top >= 1, _limb_at(m, m_top - 1), 0).to(F32)
    mt2 = torch.where(m_top >= 2, _limb_at(m, m_top - 2), 0).to(F32)
    m_scaled_f32 = mt0 + mt1 * 2.0 ** -16 + mt2 * 2.0 ** -32

    groups = iterations_for_bits(nbits) // W

    f = f_mag.to(I32)
    g = g_mag.to(I32)
    delta = torch.ones(f.shape[:-1], dtype=I32, device=f.device)
    # Bezout accumulators (mod m), times 2^(-W k) after k groups: (P, Q)
    # is the f-row of the transition matrix, (R, S) the g-row; P, R
    # multiply f0 and Q, S multiply g0
    one = torch.zeros_like(f)
    one[..., 0] = 1
    P, Q, R, S = one, torch.zeros_like(f), torch.zeros_like(f), one.clone()
    for k in range(groups):
        go = (g != 0).any()  # the JAX loop's condition, on the device
        if k % SYNC_EVERY == 0 and not bool(go):
            break
        delta2, u, v, q, r = _divstep_group(delta, f[..., 0], g[..., 0])
        f2, g2 = _apply_to_fg(u, v, q, r, f, g)
        P2, R2 = _apply_bezout_mod(u, v, q, r, P, R, m, m8, minv_w,
                                   m_scaled_f32, m_top)
        Q2, S2 = _apply_bezout_mod(u, v, q, r, Q, S, m, m8, minv_w,
                                   m_scaled_f32, m_top)
        delta, f, g, P, Q, R, S = (torch.where(go, new, old) for new, old in zip(
            (delta2, f2, g2, P2, Q2, R2, S2), (delta, f, g, P, Q, R, S)))

    # f holds ±gcd (redundant); P*f0 + Q*g0 ≡ f_final (mod m): flip the
    # Bezout signs when f_final < 0
    sf, d = canonicalize_fast(f)
    sP, mP = canonicalize_fast(P)
    sQ, mQ = canonicalize_fast(Q)
    flip = sf < 0
    u = _mod_into_range(torch.where(flip, -sP, sP), mP, m)
    v = _mod_into_range(torch.where(flip, -sQ, sQ), mQ, m)
    return d, u, v


def _mod_into_range(sign, mag, m):
    """Signed value with |value| < 4m -> canonical residue in [0, m)."""
    x = sign[..., None] * mag
    for _ in range(4):
        s, mg = canonicalize_fast(x)
        too_big = (s > 0) & (mag_cmp(mg, m) >= 0)
        neg = s < 0
        x = s[..., None] * mg + torch.where(neg[..., None], m, 0) \
            - torch.where(too_big[..., None], m, 0)
    return canonicalize_fast(x)[1]
