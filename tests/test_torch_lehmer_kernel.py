"""K7 (cofhe_tpu_torch/csrc/lehmer_euclid.cu), the NUCOMP tail's Lehmer
walk, on the CPU: a numpy model of the kernel's per-lane schedule against
the batch plain version (rl.lehmer_euclid), and the NUCOMP compose2 on the
card's route reading nothing on the host (what its CUDA graph capture
needs).

The model runs each lane alone, as a warp does: its ordered value
estimates over the eight nonzero terms only (pow2f drops the rest), cut
at XLA-CPU's windows of 32 above 32 limbs, left to right up to 18 and in
XLA's lane plan at 19-32; its digit and Lehmer steps; each lane leaving at
its first idle group (kernel A), then, with G = min(max_groups, max stop
group), its groups up to G until an idle group changes no limb (kernel B:
a carry pass is not idempotent, so a lane that stopped early keeps taking
the batch loop's carry passes). It must give the plain version's seven
outputs limb for limb and `iters`, at 16, 24, 40 and 144 limbs, on lanes
with quotient gaps past 2^13 (the digit step), inactive lanes, lanes
finished at entry, lanes stopped by the y cap and lanes cut at max_groups.
Change the model with the kernel.

The model's simulation is the kernel's: no integer division on the
common path (the quotient from an f32 estimate, floored by a magic-number
add and corrected once by its remainder; the 2^13 clip tested with one
product and its bound divided only where it binds). It is held to the
plain version's floor-division steps on random and edge top words and
matrix states, with the estimate off by up to 2^-20 either way (the
kernel's reciprocal and roundings stay below that).

On a CUDA card (`-m cuda`): K7 against the plain version on the card, and
the NUCOMP compose2 by graph replay against the eager NUCOMP compose2 and
the default compose2. Tolerance: exact equality everywhere.
"""

import random

import numpy as np
import pytest
import torch

from cofhe_tpu.core.qfi import compose, identity_form, nupow
from cofhe_tpu_torch.ops import cuda_group
from cofhe_tpu_torch.ops import limb as lb
from cofhe_tpu_torch.ops import rl
from cofhe_tpu_torch.ops.forms import BForm, bform_from_forms, bform_to_forms
from cofhe_tpu_torch.ops.forms2 import CG
from test_torch_forms2 import _cgs, _tuples
from test_torch_graphs import _guarded, _NoSync, _opaque_kernels, _plain

torch.set_num_threads(1)

F32 = np.float32
LIM = 1 << 13

# ------------------------------------------------------------ the model


def _pow2f(e):
    return F32(0.0) if e < -126 else F32(2.0 ** min(e, 127))


def _log2_f32(v):
    bits = int(np.array(max(v, F32(1e-30)), F32).view(np.int32))
    e = F32((bits >> 23) - 127)
    frac = np.array((bits & 0x7FFFFF) | (127 << 23), np.int32).view(F32)[()]
    approx = e + (frac - F32(1.0)) * (F32(2.0) - frac * F32(0.5)) * F32(0.7219281)
    return F32(-200.0) if v <= F32(1e-30) else approx


def _bits(mant, top):
    return F32(16 * top) + _log2_f32(abs(mant))


def _xla_row(t, n):
    """csrc warp_limbs.cuh sum_xla_row: n <= 32 terms in XLA-CPU's order."""
    if n <= 18:
        acc = F32(0.0)
        for i in range(n):
            acc = acc + t[i]
        return acc
    lanes, offs, start, paired = (
        (8, (0, 8), 16, True) if n == 19 else
        (4, (0, 4, 8, 12), 16, True) if n <= 23 else
        (8, (0, 8, 16), 24, True) if n <= 27 else
        (4, (0, 8, 16, 12, 4, 20), 24, False) if n <= 31 else
        (8, (0, 8, 16, 24), 32, True))
    v = [t[offs[0] + k] for k in range(lanes)]
    for o in offs[1:]:
        v = [v[k] + t[o + k] for k in range(lanes)]
    while len(v) > 1:
        h = len(v) // 2
        v = [v[k] + v[k + h] for k in range(h)]
    acc, q0 = v[0], start
    if paired:
        odd = F32(0.0)
        for q in range(start, n - 1, 2):
            acc, odd = acc + t[q], odd + t[q + 1]
        acc = acc + odd
        q0 = start + 2 * ((n - start) // 2)
    for q in range(q0, n):
        acc = acc + t[q]
    return acc


def _est(x, L):
    """wl::value_est_ordered: (mant, top, bits)."""
    nz = np.flatnonzero(x)
    top = int(nz[-1]) if len(nz) else 0
    terms = [(i, F32(int(x[i])) * _pow2f(16 * (i - top)))
             for i in range(top - 7, top + 1) if i >= 0]
    if 18 < L <= 32:
        t = [F32(0.0)] * 32
        for i, v in terms:
            t[i] = v
        mant = _xla_row(t, L)
    else:  # left to right, cut at the windows of 32 above 32 limbs: the
        # terms k = 0..7 (limb top - 7 + k, 0 below limb 0) before the term
        # kc that opens a window and from it on, as two sums in order, each
        # with the other's terms as zeros
        front = ((32 - L % 32) % 32) // 2
        kc = (32 - ((top - 7 + front) & 31)) & 31
        if not (L > 32 and 1 <= kc <= 7 and top - 7 + kc > 0):
            kc = 8
        val = dict(terms)
        left = right = F32(0.0)
        for k in range(8):
            v = val.get(top - 7 + k, F32(0.0))
            left = left + (v if k < kc else F32(0.0))
            right = right + (F32(0.0) if k < kc else v)
        mant = left + right
    return mant, top, _bits(mant, top)


def _carry(x):
    c = (x + (1 << 15)) >> 16
    out = x - (c << 16)
    out[1:] += c[:-1]
    out[-1] = x[-1] + (c[-2] if len(x) > 1 else 0)
    return out


def _fdiv(a, b):
    return a // b  # Python's floor division, as torch's rounding_mode="floor"


def _wrap32(x):
    return ((x + (1 << 31)) % (1 << 32)) - (1 << 31)


def _f32_quot(a, b, rel):
    """An f32 estimate of a / b off by the factor 1 + rel (the kernel's
    __fdividef of two rounded operands is within 2^-20 of it)."""
    return float(F32(float(F32(a) / F32(b)) * (1.0 + rel)))


def _floor_small(f):
    """wl::floor_small: f added to 1.5 * 2^23 rounding down, the sum's f32
    bits less those of 1.5 * 2^23."""
    t = F32(f) + F32(12582912.0)
    if float(t) > float(f) + 12582912.0:  # rounded up: step down one f32 unit
        t = np.nextafter(t, F32(-np.inf))
    return int(np.array(t, F32).view(np.int32)) - 0x4B400000


def _floor_quot(a, b, rel=0.0):
    """wl::floor_quot: the estimate read as floor_small does, then one
    correction by the remainder taken with b's sign on both, computed mod
    2^32 as the kernel does."""
    q = _floor_small(_f32_quot(a, b, rel))
    s = -1 if b < 0 else 1
    r = _wrap32(s * a + q * -s * b)
    return q + (r >> 31) - ((s * b - 1 - r) >> 31)


def _quot_small(n, e, rel=0.0):
    """wl::quot_small: floor(n / e) for 0 <= n, 1 <= e below 2^14."""
    q = int(np.floor(F32(_f32_quot(n, e, rel))))
    r = n - q * e
    return q + (r >= e) - (r < 0)


def _sim_plain(up, vc, m, sim_steps=8):
    """The plain version's continued-fraction steps of one lane: floor
    divisions for the quotient and its bound."""
    parg = 0
    for _ in range(sim_steps):
        qmax = _fdiv(LIM - max(abs(m[0]), abs(m[1])), max(abs(m[2]), abs(m[3]), 1))
        if not (abs(vc) > 32 and qmax > 0):
            break
        q = min(max(_fdiv(up, vc), -qmax), qmax)
        up, vc = vc, up - q * vc
        m = [m[2], m[3], m[0] - q * m[2], m[1] - q * m[3]]
        parg ^= 1
    return up, vc, m, parg


def _sim_k7(up, vc, m, sim_steps=8, rel=0.0):
    """K7's steps: the quotient from floor_quot, the clip tested with one
    product and its bound computed only where it binds, `can` one
    comparison."""
    parg = 0
    for _ in range(sim_steps):
        emax = max(abs(m[2]), abs(m[3]), 1)
        room = LIM - max(abs(m[0]), abs(m[1]))
        if not (abs(vc) > 32 and room >= emax):
            break
        q = _floor_quot(up, vc, rel)
        if min(abs(q), 1 << 14) * emax > room:
            qmax = _quot_small(room, emax, rel)
            q = -qmax if q < 0 else qmax
        up, vc = vc, _wrap32(up - q * vc)
        m = [m[2], m[3], _wrap32(m[0] - q * m[2]), _wrap32(m[1] - q * m[3])]
        parg ^= 1
    return up, vc, m, parg


def _digit(mx, tx, mm, tm):
    """rl.digit_est(..., 24, exp_clamp=26), no jmax."""
    ratio = mx / max(mm, F32(1e-30))
    ebits = 16 * (tx - tm)
    lg = -200 if ratio == 0 else ((int(np.array(abs(ratio), F32).view(np.int32)) >> 23) - 127)
    j = max(_fdiv(ebits + lg + 1 - 24 + 15, 16), 0)
    lim = F32((1 << 24) - 1)
    q = np.rint(ratio * _pow2f(min(max(ebits - 16 * j, -126), 26)))
    return int(min(max(q, -lim), lim)), j


def _submul_shift(x, v, qd, jj):
    s, a = int(qd > 0) - int(qd < 0), abs(qd)
    lo, hi = (a & 0xFFF) * s, (a >> 12) * s
    p = _carry(lo * v) + _carry(hi * _carry(v << 12))
    sh = np.zeros_like(p)
    if jj < len(x):
        sh[jj:] = p[:len(x) - jj]
    return _carry(x - sh)


def _top_word(mant, top, sh):
    e = int(min(max(F32(16 * top) - sh, F32(-126.0)), F32(30.0)))
    return int(np.rint(mant * _pow2f(e)))


def _group(s, w, lane, L, sim_steps):
    """One group of K7's `group`: (w_f, on, moved)."""
    mp, tp, bp = _est(s["rp"], L)
    mc, tc, bc = _est(s["rc"], L)
    by = _est(s["yc"], L)[2]
    wf = lane["active"] and bc > lane["stop"] and by < lane["y_cap"]
    on = w and wf
    if not on:
        moved = False
        for k in ("rp", "rc", "xp", "xc", "yp", "yc"):
            new = _carry(s[k])
            moved |= not np.array_equal(new, s[k])
            s[k] = new
        return wf, False, moved
    if bp - bc > F32(20.0):
        qd, jj = _digit(mp, tp, abs(mc), tc)
        qd *= int(mc > 0) - int(mc < 0)
        for p, c in (("rp", "rc"), ("xp", "xc"), ("yp", "yc")):
            s[p] = _submul_shift(s[p], s[c], qd, jj)
        return wf, True, False
    sh = max(bp, bc) - F32(26.0)
    up, vc = _top_word(mp, tp, sh), _top_word(mc, tc, sh)
    _, _, m, parg = _sim_k7(up, vc, [1, 0, 0, 1], sim_steps)
    for p, c in (("rp", "rc"), ("xp", "xc"), ("yp", "yc")):
        s[p], s[c] = (_carry(m[0] * s[p] + m[1] * s[c]),
                      _carry(m[2] * s[p] + m[3] * s[c]))
    s["par"] ^= parg
    return wf, True, False


def k7_model(r0, r1, stop, max_groups, active=None, sim_steps=8):
    """K7's schedule on numpy (B, L) magnitudes: kernel A lane by lane, in
    the order its warps take them, then kernel B, a chunk of 32 lanes at a
    time, the lanes its ballot marks. Returns the seven outputs, iters and
    the lanes kernel B changed."""
    B, L = r0.shape
    lanes, states, stops, gs = [], [], [], []
    for b in range(B):
        x0, x1 = r0[b].astype(np.int64), r1[b].astype(np.int64)
        lane = {"stop": F32(stop[b]),
                "active": True if active is None else bool(active[b])}
        lane["y_cap"] = _est(x0, L)[2] - lane["stop"] + F32(24.0)
        w = lane["active"] and _est(x1, L)[2] > lane["stop"]
        one = np.zeros(L, np.int64)
        one[0] = 1
        s = {"rp": _carry(x0), "rc": _carry(x1), "xp": one.copy(),
             "xc": np.zeros(L, np.int64), "yp": np.zeros(L, np.int64),
             "yc": one.copy(), "par": 0, "count": 0}
        g, done = 0, False
        while g < max_groups and w:
            w, on, moved = _group(s, True, lane, L, sim_steps)
            g += 1
            s["count"] += on
            if not on:
                done = not moved
        lanes.append(lane)
        states.append(s)
        gs.append(g)
        stops.append(-1 if done or g == max_groups else g)
    G = min(max(gs), max_groups)  # the batch loop's groups
    changed = []
    todo = [b for first in range(0, B, 32) for b in range(first, min(first + 32, B))
            if 0 <= stops[b] < G]
    for b in todo:
        lane, s, t = lanes[b], states[b], stops[b]
        before = {k: v.copy() for k, v in s.items() if k.startswith(("r", "x", "y"))}
        w = False
        for _ in range(t, G):
            wf, on, moved = _group(s, w, lane, L, sim_steps)
            s["count"] += on
            if not on and not moved and not wf:
                break
            w = wf
        if any(not np.array_equal(before[k], s[k]) for k in before):
            changed.append(b)
    rows = tuple(np.stack([s[k] for s in states]).astype(np.int32)
                 for k in ("rp", "rc", "xp", "xc", "yp", "yc"))
    par = np.array([s["par"] for s in states], np.int32)
    iters = np.array([s["count"] for s in states], np.int32)
    return rows + (par,), iters, changed


# ------------------------------------------- the division-free Lehmer step

RELS = (-2.0 ** -20, 0.0, 2.0 ** -20)  # the estimate's error, both ways
QMAXES = (1, 2, 3, 4095, 8191)


def _quot_cases(seed, n):
    """(a, b) pairs: random |a|, |b| < 2^28 of both signs (|b| >= 33, as
    `can` leaves it), and the edges: |b| = 33, |a| < |b|, exact multiples
    and their neighbours at quotients 0, +-1, +-qmax, +-qmax +- 1, +-2^13,
    around +-2^14, +-2^19 and +-2^20, and a at +-(2^28 - 1)."""
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        b = rng.randrange(33, 1 << rng.randrange(6, 29)) * rng.choice((-1, 1))
        out.append((rng.randrange(-(1 << 28) + 1, 1 << 28), b))
        out.append((rng.randrange(-(1 << rng.randrange(1, 29)), 1 << 28) // 3, b))
    qs = {0, 1, 2, 3, 4, 4094, 4095, 4096, 8190, 8191, 8192, 8193}
    qs |= set(range((1 << 14) - 5, (1 << 14) + 6)) | set(range((1 << 19) - 3, (1 << 19) + 3)) | set(range((1 << 20) - 3, (1 << 20) + 3))
    for _ in range(n // 4):
        b = rng.choice((33, 34, rng.randrange(33, 1 << 14), rng.randrange(1 << 14, 1 << 28)))
        b *= rng.choice((-1, 1))
        for q in qs:
            for sq in (-1, 1):
                for d in (0, 1, -1, abs(b) - 1, 1 - abs(b)):
                    a = sq * q * b + d
                    if abs(a) < 1 << 28:
                        out.append((a, b))
        out += [((1 << 28) - 1, b), (1 - (1 << 28), b)]
        out.append((rng.randrange(-abs(b) + 1, abs(b)), b))  # |a| < |b|
        out.append((0, b))
    return out


@pytest.mark.parametrize("rel", RELS)
def test_floor_quot_is_the_floor_division(rel):
    """wl::floor_quot against Python's floor division: exact while
    |a / b| < 2^19, past that of the quotient's sign and above 2^18 in
    magnitude, so every clip to |q| <= qmax <= 2^13 gives the floor
    division's clipped quotient, for an estimate off by up to 2^-20 either
    way."""
    for a, b in _quot_cases(11, 4000):
        want, got = a // b, _floor_quot(a, b, rel)
        if abs(a) < (1 << 19) * abs(b):
            assert got == want, (a, b)
        else:
            assert (got > 0) == (want > 0) and abs(got) > 1 << 18, (a, b, got)
        for qm in QMAXES:
            assert min(max(got, -qm), qm) == min(max(want, -qm), qm), (a, b, qm)


@pytest.mark.parametrize("rel", RELS)
def test_quot_small_is_the_floor_division(rel):
    """wl::quot_small, the clip's bound floor((2^13 - epmx) / emax), on
    every divisor with exact multiples, their neighbours and random
    numerators below 2^13."""
    rng = random.Random(12)
    for e in range(1, LIM):
        ns = {0, e - 1, e, e + 1, LIM - 1, rng.randrange(LIM)}
        k = rng.randrange(1, LIM // e + 1)
        ns |= {k * e - 1, k * e, k * e + 1}
        for n in ns:
            if 0 <= n < LIM:
                assert _quot_small(n, e, rel) == n // e, (n, e)


def _states(rng, n):
    """Matrix states (mp0, mp1, mc0, mc1): the identity, random ones, and
    rows at the edge of the 2^13 bound: epmx + emax = 2^13 (qmax = 1) and
    epmx + emax = 2^13 + 1 (qmax = 0, the walk stops)."""
    out = [[1, 0, 0, 1]]
    for _ in range(n):
        emax = rng.randrange(1, LIM)
        for epmx in (LIM - emax, LIM + 1 - emax, rng.randrange(1, LIM - emax + 1)):
            mp = [epmx * rng.choice((-1, 1)), rng.randrange(-epmx, epmx + 1)]
            mc = [emax * rng.choice((-1, 1)), rng.randrange(-emax, emax + 1)]
            rng.shuffle(mp)
            rng.shuffle(mc)
            out.append(mp + mc)
    return out


@pytest.mark.parametrize("rel", RELS)
def test_k7_simulation_is_the_plain_simulation(rel):
    """K7's continued-fraction steps (the division-free quotient, the clip
    tested with one product and its bound divided only where it binds, can
    as one comparison) against the plain version's floor-division steps:
    the same top words, matrix and parity after up to eight steps, from
    random and edge states, at random top words of both signs below 2^28
    and at the edges of _quot_cases."""
    rng = random.Random(13)
    states = _states(rng, 300)
    pairs = _quot_cases(14, 300)
    for k in range(3000):
        up, vc = pairs[rng.randrange(len(pairs))] if k % 2 else \
            (rng.randrange(-(1 << 28) + 1, 1 << 28), rng.randrange(-(1 << 28) + 1, 1 << 28))
        m = states[k % len(states)]
        assert _sim_k7(up, vc, m, rel=rel) == _sim_plain(up, vc, m), (up, vc, m)
        assert _sim_k7(up, vc, m, sim_steps=1, rel=rel) == _sim_plain(up, vc, m, 1)


# -------------------------------------------------------------- the lanes


def _lanes(L, bits, seed):
    """(r0, r1, stop, active) with every kind of lane."""
    rng = random.Random(seed)
    B = 32
    r0 = [rng.getrandbits(rng.randrange(bits // 2, bits)) | 1 for _ in range(B)]
    r1 = [rng.randrange(1, x) for x in r0]
    stop = [rng.choice((20.0, bits / 4, bits / 3 + 0.5)) for _ in range(B)]
    for i in range(6):  # r0 = q r1 + small, q > 2^13: the digit step
        r1[i] = rng.getrandbits(bits // 3) + 1
        q = rng.getrandbits(rng.randrange(14, bits // 3)) | (1 << 14)
        r0[i] = q * r1[i] + rng.randrange(r1[i])
        stop[i] = 10.0
    for i in (6, 7):  # r1 far below r0
        r1[i] = rng.getrandbits(rng.randrange(24, bits // 3)) + 1
        stop[i] = 10.0
    stop[8] = float(bits)      # finished at entry: bits(r1) <= stop
    r1[9] = r0[9]              # r1 = r0
    r1[10] = 1
    r0[11] = 1                 # y_cap = 24 - stop < 0: stopped by the y cap
    stop[11] = 30.0
    r0[12], r1[12] = 0, r1[13] # r0 = 0: the y cap again
    stop[12] = 5.0
    for i in (14, 15):         # never stop: rc reaches 0 above bits_stop
        stop[i] = -300.0
    active = np.ones(B, bool)
    active[16] = active[17] = False
    return (lb.ints_to_limbs(r0, L), lb.ints_to_limbs(r1, L),
            np.array(stop, np.float32), active)


def _plain_run(m0, m1, stop, max_groups, active):
    iters = torch.zeros(m0.shape[0], dtype=torch.int32)
    out = rl.lehmer_euclid(torch.from_numpy(m0), torch.from_numpy(m1),
                           torch.from_numpy(stop), max_groups,
                           active=torch.from_numpy(active), iters=iters)
    return [o.numpy() for o in out], iters.numpy()


@pytest.mark.parametrize("L,bits,max_groups", [(16, 220, 60), (24, 330, 80),
                                               (40, 600, 110), (144, 2100, 178)])
def test_k7_model_matches_the_plain_version(L, bits, max_groups):
    m0, m1, stop, active = _lanes(L, bits, L)
    want, want_iters = _plain_run(m0, m1, stop, max_groups, active)
    got, iters, changed = k7_model(m0, m1, stop, max_groups, active)
    for k, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(g, w), k
    assert np.array_equal(iters, want_iters)
    # every kind of lane is there
    assert int(iters[:6].min()) > 0
    assert iters[8] == iters[11] == iters[12] == 0
    assert iters[14] == iters[15] == max_groups
    assert iters[16] == iters[17] == 0
    assert int(iters.max()) == max_groups


def test_k7_model_cut_at_max_groups():
    """A cap below the walk's length: every working lane is cut, and the
    lanes that left earlier still take the carry passes up to the cap."""
    m0, m1, stop, active = _lanes(40, 600, 3)
    want, want_iters = _plain_run(m0, m1, stop, 7, active)
    got, iters, _ = k7_model(m0, m1, stop, 7, active)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert np.array_equal(iters, want_iters) and int(iters.max()) == 7


def test_dispatcher_on_cpu_tensors_is_the_plain_version():
    m0, m1, stop, active = _lanes(24, 330, 5)
    args = (torch.from_numpy(m0), torch.from_numpy(m1), torch.from_numpy(stop), 80)
    it_d, it_p = torch.zeros(32, dtype=torch.int32), torch.zeros(32, dtype=torch.int32)
    got = cuda_group.lehmer_euclid(*args, active=torch.from_numpy(active), iters=it_d)
    want = rl.lehmer_euclid(*args, active=torch.from_numpy(active), iters=it_p)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(it_d, it_p)
    # a CPU tensor never reaches the kernel's wrapper
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_group.lehmer_euclid_cuda(*args)


def test_nucomp_compose2_card_route_reads_nothing_on_the_host(toy_hsm, monkeypatch):
    """The NUCOMP compose2 a CUDA graph captures, on the CPU: with every
    kernel (K7 among them) an opaque call to its plain version and the
    card's route, it reads no tensor on the host, walks once, takes its
    canonicalizations through K6a and gives the default compose2's
    reduced forms."""
    jcg, pcg, L = _cgs(toy_hsm)
    ncg = CG(pcg.disc_bits, pcg.delta4, pcg.h, pcg.h2, use_nucomp=True)
    rng = random.Random(9)
    pool = [nupow(toy_hsm.h, rng.randrange(1, 1 << 60)) for _ in range(8)]
    f1 = [pool[rng.randrange(8)] for _ in range(12)]
    f2 = [pool[rng.randrange(8)] for _ in range(12)]
    f1[0] = identity_form(toy_hsm.Delta)
    f1[1] = f2[1]
    p1, p2 = bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu")
    want = _tuples(compose(a, b) for a, b in zip(f1, f2))
    monkeypatch.setattr(cuda_group, "plain_route", lambda t: False)
    with _opaque_kernels(monkeypatch) as calls:
        out = ncg.compose2_eager(_guarded(p1), _guarded(p2))
    assert isinstance(out.a, _NoSync)
    assert calls["lehmer_euclid"] == 1
    # K6a: compose2's four sums, then the tail's cofactors (two pairs), its
    # two form values (one pair) and the cross term; K6b, K6c, K6d and K6e
    # once
    assert (calls["canon_sm"], calls["compose_prologue"]) == (8, 1)
    assert calls["gcd_bridge"] == calls["gcd2_merge"] == calls["c3_operands"] == 1
    assert _tuples(bform_to_forms(BForm(*(_plain(x) for x in out)))) == want


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K7 and CUDA graphs")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k7_matches_the_plain_version_on_card(cuda_device):
    for L, bits, max_groups in ((16, 220, 60), (24, 330, 80), (40, 600, 110),
                                (144, 2100, 178)):
        m0, m1, stop, active = _lanes(L, bits, L)
        args = [torch.from_numpy(a).to(cuda_device) for a in (m0, m1, stop, active)]
        it_k = torch.zeros(32, dtype=torch.int32, device=cuda_device)
        it_p = torch.zeros(32, dtype=torch.int32, device=cuda_device)
        got = cuda_group.lehmer_euclid_cuda(*args[:3], max_groups, active=args[3],
                                            iters=it_k)
        want = cuda_group.lehmer_euclid_plain(*args[:3], max_groups, active=args[3],
                                              iters=it_p)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), L
        assert torch.equal(it_k, it_p), L


@pytest.mark.cuda
def test_nucomp_compose2_replay_matches_eager_and_default_on_card(cuda_device):
    from conftest import toy_prime
    from cofhe_tpu_torch.core.cl_hsm2k import CLHSM2k
    from cofhe_tpu_torch.ops.engine import TorchEngine

    hsm = CLHSM2k(128, 32, p=toy_prime(100))
    cg = TorchEngine(hsm, cuda_device).cg
    ncg = CG(cg.disc_bits, cg.delta4, cg.h, cg.h2, use_nucomp=True)
    rng = random.Random(6)
    pool = [nupow(hsm.h, rng.randrange(1, 1 << 60)) for _ in range(16)]
    f1 = [pool[rng.randrange(16)] for _ in range(128)]
    f2 = [pool[rng.randrange(16)] for _ in range(128)]
    b1 = bform_from_forms(f1, cg.L, cuda_device)
    b2 = bform_from_forms(f2, cg.L, cuda_device)
    # replays against the bodies they captured, eager, and the default tail
    for g, e, d in ((ncg.compose2(b1, b2), ncg.compose2_eager(b1, b2), cg.compose2(b1, b2)),
                    (ncg.nudupl2(b1), ncg.compose2_eager(b1, b1), cg.nudupl2(b1))):
        for x, y, z in zip(g, e, d):
            assert torch.equal(x, y) and torch.equal(x, z)
    (graph,) = ncg.compose_graphs.graphs.values()
    assert sum(k[0] == "lehmer_euclid" for k in graph.keys) == 1
    assert _tuples(bform_to_forms(ncg.compose2(b1, b2))) == \
        _tuples(compose(a, b) for a, b in zip(f1, f2))
