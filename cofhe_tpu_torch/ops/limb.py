"""Batched fixed-width big-integer arithmetic on int32 limb tensors (torch).

Port of cofhe_tpu/ops/limb.py (the subset the v2 compose kernel needs).
Representation is unchanged:

* a magnitude is `(..., L)` int32, little-endian base-2^16 limbs in
  [0, 2^16); a signed number is `(sign, mag)` with `sign` int32 in
  {-1, 0, +1} of shape `(...,)`;
* "redundant" intermediates carry arbitrary int32 limbs (|limb| < 2^31) and
  `canonicalize_fast` turns them back into sign-magnitude.

Every function returns the same integers as its JAX counterpart; where the
TPU version was shaped by Mosaic's lowering rules (no gathers, no scans) this
module uses the torch idiom that needs fewer kernel launches instead — the
carry resolution is a table-driven prefix composition, dynamic limb shifts
are `gather`s, products go through a float64 FFT of 8-bit limbs and exact
division uses a 2-adic Newton inverse. Outputs are canonical integers, so
the route does not show in them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

BASE_BITS = 16
BASE = 1 << BASE_BITS
MASK = BASE - 1

I32 = torch.int32

# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------


def ints_to_limbs(values, L: int) -> np.ndarray:
    """Python ints -> (n, L) int32 magnitude limbs (host-side; one
    int.to_bytes per value, C-speed)."""
    n = len(values)
    buf = bytearray(n * L * 2)
    nb = L * 2
    for i, v in enumerate(values):
        a = abs(int(v))
        buf[i * nb:(i + 1) * nb] = a.to_bytes(nb, "little")  # raises if too big
    return np.frombuffer(bytes(buf), dtype="<u2").reshape(n, L).astype(np.int32)


def ints_to_signed(values, L: int):
    sign = np.array([(int(v) > 0) - (int(v) < 0) for v in values], dtype=np.int32)
    return sign, ints_to_limbs(values, L)


def limbs_to_ints(mag, sign=None) -> list[int]:
    if isinstance(mag, torch.Tensor):
        mag = mag.cpu().numpy()
    if isinstance(sign, torch.Tensor):
        sign = sign.cpu().numpy()
    mag = np.asarray(mag)
    flat = np.ascontiguousarray(mag.reshape(-1, mag.shape[-1]).astype("<u2"))
    nb = flat.shape[1] * 2
    raw = flat.tobytes()
    vals = [int.from_bytes(raw[i * nb:(i + 1) * nb], "little")
            for i in range(flat.shape[0])]
    if sign is not None:
        s = np.asarray(sign).reshape(-1)
        vals = [int(si) * v for si, v in zip(s, vals)]
    return vals


# ---------------------------------------------------------------------------
# small tensor helpers
# ---------------------------------------------------------------------------

_CONST: dict = {}


def _arange(L: int, device) -> torch.Tensor:
    key = ("arange", L, str(device))
    t = _CONST.get(key)
    if t is None:
        t = torch.arange(L, dtype=I32, device=device)
        _CONST[key] = t
    return t


def _shift_up(x, k: int, fill: int = 0):
    """Move limbs k places toward the top (limb i <- limb i-k); the bottom
    k limbs get `fill`, the top k limbs fall off."""
    L = x.shape[-1]
    if k >= L:
        return torch.full_like(x, fill)
    return F.pad(x[..., :L - k], (k, 0), value=fill)


def _shift_down(x, k: int = 1):
    """Move limbs k places toward the bottom (limb i <- limb i+k); zeros
    enter at the top."""
    L = x.shape[-1]
    if k >= L:
        return torch.zeros_like(x)
    return F.pad(x[..., k:], (0, k))


def one_limbs(shape_lead, L: int, device) -> torch.Tensor:
    """The value 1 as (..., L) limbs."""
    out = torch.zeros(tuple(shape_lead) + (L,), dtype=I32, device=device)
    out[..., 0] = 1
    return out


# ---------------------------------------------------------------------------
# carries / canonicalization
# ---------------------------------------------------------------------------


def _bound_limbs(x):
    """Two floor carry passes: every limb but the top lands in [-1, 2^16]
    (from |limb| < 2^31); the top limb keeps its own carries."""
    L = x.shape[-1]
    if L == 1:
        return x
    for _ in range(2):
        c = x >> BASE_BITS
        out = (x & MASK) + _shift_up(c, 1)
        out[..., L - 1] = x[..., L - 1] + c[..., L - 2]
        x = out
    return x


def _compose_table(device) -> torch.Tensor:
    """Composition table of the 27 maps {-1,0,1} -> {-1,0,1}, encoded
    e = 9*(f(-1)+1) + 3*(f(0)+1) + (f(1)+1): T[27*g + h] = code(g o h)."""
    key = ("comp3", str(device))
    t = _CONST.get(key)
    if t is None:
        vals = [(e // 9 - 1, (e // 3) % 3 - 1, e % 3 - 1) for e in range(27)]
        tab = np.zeros(729, dtype=np.int32)
        for g in range(27):
            for h in range(27):
                comp = [vals[g][vals[h][i] + 1] for i in range(3)]
                tab[27 * g + h] = 9 * (comp[0] + 1) + 3 * (comp[1] + 1) + comp[2] + 1
        t = torch.from_numpy(tab).to(device)
        _CONST[key] = t
    return t


_ID_CODE = 5  # code of the identity map (-1, 0, 1)


def canonicalize_fast(limbs):
    """Redundant signed limbs -> (sign, mag). Requires |value| < 2^(16 L).

    After two bounding carry passes each lower limb's carry-out is one of
    27 maps of its carry-in in {-1, 0, +1}; a Kogge-Stone prefix over the
    map codes (one table lookup per round) resolves every carry."""
    x = _bound_limbs(limbs)
    L = x.shape[-1]
    if L > 1:
        low = x[..., :L - 1]
        code = (((low - 1) >> BASE_BITS) + 1) * 9 \
            + ((low >> BASE_BITS) + 1) * 3 + ((low + 1) >> BASE_BITS) + 1
        tab = _compose_table(x.device)
        k = 1
        while k < L - 1:
            code = tab[code * 27 + _shift_up(code, k, _ID_CODE)]
            k *= 2
        carry = (code // 3) % 3 - 1          # prefix map evaluated at 0
        t = x + F.pad(carry, (1, 0))
    else:
        t = x
    mag = t & MASK
    is_neg = (t[..., L - 1] >> BASE_BITS) < 0
    mag = torch.where(is_neg[..., None], _negate_mag_fast(mag), mag)
    nonzero = (mag != 0).any(-1)
    sign = torch.where(is_neg, -1, 1).to(I32) * nonzero.to(I32)
    return sign, mag


def _negate_mag_fast(mag):
    """2^(16L) - mag (mod 2^(16L)): limbs below the lowest nonzero limb stay
    0, that limb becomes 2^16 - limb, every limb above it 2^16 - 1 - limb."""
    seen = torch.cummax((mag != 0).to(I32), dim=-1).values
    below = _shift_up(seen, 1).bool()
    return torch.where(below, MASK - mag, (BASE - mag) & MASK)


def canonicalize_nonneg(limbs):
    """Canonical magnitude (mod 2^(16 L)) of a NONNEGATIVE redundant value
    (limbs in [0, ~2^26)). After the bounding passes carries are {0, 1}: the
    carry into limb i is 1 iff the highest limb below i that is not 2^16-1
    equals 2^16 — a running max over (index, generates) codes."""
    x = _bound_limbs(limbs)
    L = x.shape[-1]
    if L == 1:
        return x & MASK
    low = x[..., :L - 1]
    idx = _arange(L - 1, x.device)
    enc = torch.where(low != MASK, 2 * idx + (low == BASE).to(I32), -1)
    last = torch.cummax(enc, dim=-1).values
    carry = ((last >= 0) & ((last & 1) == 1)).to(I32)
    return (x + F.pad(carry, (1, 0))) & MASK


def resize(mag, L: int):
    """Zero-pad (or truncate — caller must guarantee value-preserving) the
    limb axis to length L."""
    cur = mag.shape[-1]
    if cur == L:
        return mag
    if cur < L:
        return F.pad(mag, (0, L - cur))
    return mag[..., :L]


# ---------------------------------------------------------------------------
# signed arithmetic
# ---------------------------------------------------------------------------


def sm_add(a, b):
    sa, ma = a
    sb, mb = b
    L = max(ma.shape[-1], mb.shape[-1])
    return canonicalize_fast(sa[..., None] * resize(ma, L)
                             + sb[..., None] * resize(mb, L))


def sm_sub(a, b):
    sb, mb = b
    return sm_add(a, (-sb, mb))


def mag_cmp(ma, mb):
    """Lexicographic magnitude compare -> (...,) int32 in {-1, 0, 1}: the
    highest differing limb decides (max over (index, sign) codes)."""
    L = max(ma.shape[-1], mb.shape[-1])
    d = resize(ma, L) - resize(mb, L)
    idx = _arange(L, d.device)
    enc = torch.where(d != 0, 2 * idx + (d > 0).to(I32), -1)
    best = enc.amax(-1)
    return torch.where(best < 0, 0, torch.where((best & 1) == 1, 1, -1)).to(I32)


# ---------------------------------------------------------------------------
# multiplication
# ---------------------------------------------------------------------------


def _to8(mag):
    """16-bit limbs (..., L) -> 8-bit limbs (..., 2L)."""
    lo = mag & 0xFF
    hi = (mag >> 8) & 0xFF
    return torch.stack([lo, hi], dim=-1).reshape(*mag.shape[:-1], 2 * mag.shape[-1])


def _from8(x8):
    """8-bit limb vector (possibly redundant, values < 2^25) -> redundant
    16-bit limbs; the part of an odd limb that (odd << 8) would push past
    int32 moves one 16-bit limb up instead."""
    L2 = x8.shape[-1]
    if L2 % 2:
        x8 = F.pad(x8, (0, 1))
        L2 += 1
    x = x8.reshape(*x8.shape[:-1], L2 // 2, 2)
    even, odd = x[..., 0], x[..., 1]
    lo = even + ((odd & 0xFF) << 8)          # < 2^25 + 2^16
    return lo + _shift_up(odd >> 8, 1)       # odd >> 8 < 2^17


def _poly_mul8(a8, b8):
    """Exact per-row polynomial product of 8-bit limb vectors:
    (..., n) x (..., m) -> (..., n+m-1) int32.

    A float64 FFT convolution: every coefficient is an integer below
    min(n, m) * 255^2 < 2^25, and the transform's rounding error for such
    inputs (~|a|_2 |b|_2 log2(N) 2^-53 < 1e-6) is far below 1/2, so
    rounding recovers it exactly."""
    n = a8.shape[-1]
    m = b8.shape[-1]
    N = n + m - 1
    nfft = 1 << max(0, (N - 1).bit_length())
    fa = torch.fft.rfft(a8.to(torch.float64), nfft)
    fb = torch.fft.rfft(b8.to(torch.float64), nfft)
    c = torch.fft.irfft(fa * fb, nfft)[..., :N]
    return torch.round(c).to(I32)


def mag_mul(ma, mb, L_out: int | None = None):
    """Magnitude product, (..., L_out) canonical (mod 2^(16 L_out))."""
    La, Lb = ma.shape[-1], mb.shape[-1]
    if L_out is None:
        L_out = La + Lb
    c8 = _poly_mul8(_to8(ma), _to8(mb))
    return canonicalize_nonneg(resize(_from8(c8), L_out))


# ---------------------------------------------------------------------------
# shifts
# ---------------------------------------------------------------------------


def mag_shl_limbs(mag, n: int, L_out: int | None = None):
    L = mag.shape[-1]
    if L_out is None:
        L_out = L + n
    return F.pad(mag, (n, max(0, L_out - L - n)))[..., :L_out]


def mag_shl_bits(mag, bits: int, L_out: int | None = None):
    limbs, rem = divmod(bits, BASE_BITS)
    x = mag_shl_limbs(mag, limbs, L_out)
    if rem == 0:
        return x
    _, mag2 = canonicalize_fast(x << rem)
    return mag2


def mag_shr_bits(mag, bits: int):
    limbs, rem = divmod(bits, BASE_BITS)
    x = mag[..., limbs:] if limbs else mag
    if rem == 0:
        return x
    up = _shift_down(x, 1)
    return (x >> rem) | ((up << (BASE_BITS - rem)) & MASK)


def shl_limbs_dyn(x, j):
    """x * 2^(16 j) for per-element j >= 0 (limb i <- limb i-j); limbs that
    move past the top are dropped. Exact on redundant limbs."""
    L = x.shape[-1]
    src = _arange(L, x.device) - j[..., None]
    out = torch.gather(x, -1, src.clamp(min=0).long())
    return torch.where(src >= 0, out, 0)


def shr_limbs_dyn(x, j):
    """Limb i <- limb i+j for per-element j >= 0; zeros enter at the top."""
    L = x.shape[-1]
    src = _arange(L, x.device) + j[..., None]
    out = torch.gather(x, -1, src.clamp(max=L - 1).long())
    return torch.where(src < L, out, 0)


def mag_shl_bits_dyn(mag, bits):
    """Left shift by per-element dynamic bit count; caller guarantees the
    result fits the buffer."""
    limbs = bits // BASE_BITS
    r = (bits % BASE_BITS)[..., None]
    lo = shl_limbs_dyn(mag, limbs)
    dn = shl_limbs_dyn(mag, limbs + 1)
    return ((lo << r) & MASK) | (dn >> (BASE_BITS - r))


def mag_shr_bits_dyn(mag, bits):
    """Right shift by per-element dynamic bit count (0 <= bits < 16 L)."""
    limbs = bits // BASE_BITS
    r = (bits % BASE_BITS)[..., None]
    lo = shr_limbs_dyn(mag, limbs)
    up = shr_limbs_dyn(mag, limbs + 1)
    return (lo >> r) | ((up << (BASE_BITS - r)) & MASK)


# ---------------------------------------------------------------------------
# bit length / float32 surrogates
# ---------------------------------------------------------------------------


def _limb_bitlen(limb):
    pw = _CONST.get(("pow2_16", str(limb.device)))
    if pw is None:
        pw = torch.tensor([1 << j for j in range(BASE_BITS)], dtype=I32,
                          device=limb.device)
        _CONST[("pow2_16", str(limb.device))] = pw
    return (limb[..., None] >= pw).sum(-1, dtype=I32)


def _top_index(mag, fill: int):
    idx = _arange(mag.shape[-1], mag.device)
    return torch.where(mag != 0, idx, fill).amax(-1)


def _limb_at(mag, i):
    """mag[..., i] for a per-element index tensor i (clamped into range)."""
    L = mag.shape[-1]
    return torch.gather(mag, -1, i.clamp(0, L - 1).long()[..., None])[..., 0]


def mag_bitlen(mag):
    """Bit length per element; 0 for zero."""
    top = _top_index(mag, -1)
    bl = top * BASE_BITS + _limb_bitlen(_limb_at(mag, top))
    return torch.where(top < 0, 0, bl).to(I32)


def mag_float(mag):
    """value ~= mant * 2^exp with mant f32 built from the top 48 bits."""
    top = _top_index(mag, 0)
    t0 = _limb_at(mag, top)
    t1 = torch.where(top >= 1, _limb_at(mag, top - 1), 0)
    t2 = torch.where(top >= 2, _limb_at(mag, top - 2), 0)
    mant = (t0.to(torch.float32) * float(BASE) ** 2
            + t1.to(torch.float32) * float(BASE)
            + t2.to(torch.float32))
    exp = (top - 2) * BASE_BITS
    return mant, exp


# ---------------------------------------------------------------------------
# division
# ---------------------------------------------------------------------------


def mag_v2(mag):
    """2-adic valuation per element (trailing zero bits); 16*L for zero."""
    L = mag.shape[-1]
    idx = _arange(L, mag.device)
    first = torch.where(mag != 0, idx, L).amin(-1)
    limb = _limb_at(mag, first)
    tz = _limb_bitlen(limb & (-limb)) - 1
    return torch.where(first >= L, L * BASE_BITS, first * BASE_BITS + tz).to(I32)


def modinv16(y0):
    """Inverse of odd y0 modulo 2^16 (elementwise Newton, in int64 so the
    products never wrap)."""
    y = y0.to(torch.int64)
    x = y
    for _ in range(4):
        x = (x * (2 - y * x)) & MASK
    return x.to(I32)


def _sub_mod(a, b):
    """(a - b) mod 2^(16 L) for canonical (..., L) magnitudes."""
    return canonicalize_nonneg(a + _negate_mag_fast(b))


def inv_pow2(y, n: int):
    """y^-1 mod 2^(16 n) for ODD canonical y (2-adic Newton iteration:
    inv <- inv - inv * (y * inv - 1), doubling the correct limbs)."""
    yv = resize(y, n)
    inv = modinv16(yv[..., 0])[..., None]
    k = 1
    while k < n:
        k2 = min(2 * k, n)
        inv = resize(inv, k2)
        t = mag_mul(yv[..., :k2], inv, k2)     # ≡ 1 mod 2^(16 k)
        e = F.pad(t[..., 1:], (1, 0))          # t - 1: limb 0 of t is 1
        inv = _sub_mod(inv, mag_mul(inv, e, k2))
        k = k2
    return inv


def mag_divexact_odd(x, y, L_out: int, inv=None):
    """Exact division x / y for ODD y with y | x; returns the (..., L_out)
    quotient magnitude. Equals the JAX package's LSB-first Hensel digits:
    both are x * y^-1 mod 2^(16 L_out) (L_out <= x's width). `inv`, when
    the caller already has it, is y^-1 mod 2^(16 n) for some n >= L_out."""
    if L_out > x.shape[-1]:
        raise ValueError(f"L_out {L_out} exceeds the dividend width {x.shape[-1]}")
    if inv is None:
        inv = inv_pow2(y, L_out)
    return mag_mul(resize(x, L_out), resize(inv, L_out), L_out)
