"""Redundant-limb arithmetic: the v2 hot-loop toolkit (torch port of
cofhe_tpu/ops/rl.py).

Values stay REDUNDANT across loop iterations (balanced limbs after
`carry_pass`) and loops are steered by float32 estimates; only the exact
tails canonicalize. `mod_topdown` here is the plain version of the Hopper
kernel in csrc/mod_topdown.cu (ops/cuda_group.py dispatches between them).

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
