"""The chain of collectives of KT's redesign, in the shared helpers of
cofhe_tpu_torch/csrc/warp_limbs.cuh (KT, K1, K2 and K4 canonicalize and
compare through them), modelled in Python, since the kernels run only on a
card.

The model keeps what the kernels keep: a warp of 32 threads, thread t
holding limbs [t NPT, t NPT + NPT). wl::canonicalize_rows canonicalizes a
row by two floor passes, a carry map {-1, 0, 1} -> {-1, 0, 1} a limb packed
as three 2-bit fields, each thread's maps composed and then scanned over
the warp in five shuffle levels, the carries applied, and the sign taken
from the top limb's carry with the magnitude negated by a select;
wl::mag_cmp compares two canonical magnitudes from two ballots (where the
highest differing limb is, and whether it is greater).

Checked against limb.canonicalize_fast and limb.mag_cmp (the plain
versions) at every NPT 1-9 and at KT's width 144, on random redundant
limbs and on limbs at the edges of the floor passes' range (-1, 0,
0xFFFF, 0x10000), and the packed maps against the base-3 code the kernels
used before, for every pair of maps. Inputs come from seeded numpy
generators. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from cofhe_tpu_torch.ops import limb as lb

torch.set_num_threads(1)

MAP_ID = 0 | 1 << 2 | 2 << 4
WIDTHS = [1, 2, 5, 31, 32, 33, 64, 65, 100, 144, 160, 200, 224, 257, 288]


def map_apply(f, c):
    return ((f >> (2 * (c + 1))) & 3) - 1


def map_compose(g, h):
    """g o h, as the kernel composes packed maps."""
    return (((g >> (2 * (h & 3))) & 3) | (((g >> (2 * ((h >> 2) & 3))) & 3) << 2)
            | (((g >> (2 * ((h >> 4) & 3))) & 3) << 4))


def canon_row(x, W):
    """wl::canonicalize_rows on one row of W int limbs: (sign, canonical
    limbs)."""
    npt = (W + 31) // 32
    x = list(x) + [0] * (32 * npt - W)
    for _ in range(2):  # floor passes
        c = [v >> 16 for v in x]
        x = [((v & 0xFFFF) + (c[i - 1] if i else 0)) if i < W - 1
             else (v + (c[i - 1] if i else 0) if i == W - 1 else 0)
             for i, v in enumerate(x)]
    tm = []
    for t in range(32):  # each thread's composed map
        m = MAP_ID
        for j in range(npt):
            i = t * npt + j
            if i < W - 1:
                v = x[i]
                f = ((((v - 1) >> 16) + 1) | (((v >> 16) + 1) << 2)
                     | ((((v + 1) >> 16) + 1) << 4))
                m = map_compose(f, m)
        tm.append(m)
    for d in (1, 2, 4, 8, 16):  # inclusive scan, one shuffle a level
        tm = [map_compose(tm[t], tm[t - d]) if t >= d else tm[t] for t in range(32)]
    out, fin = [0] * (32 * npt), 0
    for t in range(32):
        c = map_apply(tm[t - 1], 0) if t else 0
        for j in range(npt):
            i = t * npt + j
            s = x[i] + c
            out[i] = s & 0xFFFF if i < W else 0
            c = s >> 16
            if i == W - 1:
                fin = c
    nz = [any(out[t * npt:(t + 1) * npt]) for t in range(32)]
    if fin < 0:  # the select: 2^(16 W) - mag
        for t in range(32):
            seen = any(nz[:t])
            for j in range(npt):
                i = t * npt + j
                v = out[i]
                nv = 0xFFFF - v if seen else (0x10000 - v if v else 0)
                seen = seen or v != 0
                if i < W:
                    out[i] = nv
    sign = 0 if not any(nz) else (-1 if fin < 0 else 1)
    return sign, out[:W]


def cmp(a, b, W):
    """wl::mag_cmp: two ballots over the threads' highest differing slot."""
    npt = (W + 31) // 32
    a = list(a) + [0] * (32 * npt - W)
    b = list(b) + [0] * (32 * npt - W)
    res = []
    for t in range(32):
        r = 0
        for j in range(npt):
            i = t * npt + j
            if a[i] != b[i]:
                r = 1 if a[i] > b[i] else -1
        res.append(r)
    has = sum(1 << t for t in range(32) if res[t])
    gt = sum(1 << t for t in range(32) if res[t] > 0)
    if not has:
        return 0
    return 1 if (gt >> (has.bit_length() - 1)) & 1 else -1


def base3_apply(code, c):
    v = code // 9 if c < 0 else (code % 3 if c > 0 else (code // 3) % 3)
    return v - 1


def base3(f):
    return 9 * (map_apply(f, -1) + 1) + 3 * (map_apply(f, 0) + 1) + (map_apply(f, 1) + 1)


def test_packed_maps_compose_as_the_base3_code():
    maps = [a | b << 2 | c << 4 for a in range(3) for b in range(3) for c in range(3)]
    for g in maps:
        for h in maps:
            want = [base3_apply(base3(g), base3_apply(base3(h), c)) for c in (-1, 0, 1)]
            assert [map_apply(map_compose(g, h), c) for c in (-1, 0, 1)] == want
    assert base3(MAP_ID) == 5  # the base-3 code's identity


def _rows(gen, W, n):
    """Redundant signed rows whose value fits W limbs: random limbs in
    +-2^20, limbs at the floor passes' edges, and negatives."""
    rows = []
    while len(rows) < n:
        kind = len(rows) % 3
        if kind == 0:
            x = gen.integers(-(1 << 20), 1 << 20, size=W)
        elif kind == 1:
            x = gen.choice([-1, 0, 0xFFFF, 0x10000, 1], size=W)
        else:
            x = -gen.integers(0, 1 << 16, size=W)
        x = [int(v) for v in x]
        if abs(sum(v << 16 * i for i, v in enumerate(x))) < 1 << 16 * W:
            rows.append(x)
    return rows


@pytest.mark.parametrize("W", WIDTHS)
def test_canonicalize_rows_matches_canonicalize_fast(W):
    gen = np.random.default_rng(W)
    rows = _rows(gen, W, 24)
    sg, mag = lb.canonicalize_fast(torch.tensor(rows, dtype=torch.int32))
    for x, s, m in zip(rows, sg.tolist(), mag.tolist()):
        assert canon_row(x, W) == (s, m)


@pytest.mark.parametrize("W", WIDTHS)
def test_cmp_matches_mag_cmp(W):
    gen = np.random.default_rng(100 + W)
    a = gen.integers(0, 1 << 16, size=(16, W))
    b = a.copy()
    for r in range(1, 16):  # equal rows, then one limb apart, then random
        if r < 8:
            b[r, int(gen.integers(0, W))] = int(gen.integers(0, 1 << 16))
        else:
            b[r] = gen.integers(0, 1 << 16, size=W)
    want = lb.mag_cmp(torch.tensor(a, dtype=torch.int32), torch.tensor(b, dtype=torch.int32))
    assert [cmp(x, y, W) for x, y in zip(a.tolist(), b.tolist())] == want.tolist()
