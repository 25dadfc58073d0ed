"""K5m's tensor-core product (cofhe_tpu_torch/csrc/mag_mul.cu), modelled in
Python, since the kernel runs only on a card.

The model keeps what the kernel keeps. The longer operand's 8-bit limbs
are staged reversed between zero pads as 32-bit words, the shorter one's
packed two 16-bit limbs a word, both by the kernel's own index arithmetic.
Each thread of a warp builds its A and B fragments of every
mma.m16n8k32 .u8 tile from those words, as the PTX ISA's fragment table
places them (A: four 4-byte windows through a funnel shift; B: two aligned
words), the tile is multiplied, and each thread's four C values are added
into the 8-bit columns k = m0 + row + 32 J below 2 L_out. The columns are
recombined into 16-bit limbs (c8[2l] + ((c8[2l+1] & 0xFF) << 8) + (c8[2l-1]
>> 8)) and carried mod 2^(16 L_out).

Checked at compose2's five product shapes at k=128 and at k=256 (whose t1
and sq, L_out = 296, run the wide instances), at all-0xFFFF rows of 288
and 320 limbs, and at chip_smoke.py's twenty
K5m edge shapes (widths 1 to 288, L_out below, at and above La + Lb), on
edge operands (zero, all-0xFFFF limbs, 1, top limbs alone, limbs with bits
above 16):
* the fragments decode to the Toeplitz matrix l8[m - t] and the blocks
  beta_J, for every thread of every tile;
* the columns equal the 8-bit convolution below 2 L_out, each below 2^26,
  and every recombined limb is nonnegative and below 2^27;
* the output equals Python integers and limb.mag_mul_plain;
* a tile the kernel skips adds nothing below 2 L_out; the tile counts at
  compose2's shapes; the warps of a row (WPR = 1, 2, 4) take every tile
  once, at most ceil(tiles / WPR) each.
Inputs come from seeded numpy generators. Tolerance: exact equality.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from cofhe_tpu_torch.ops import limb as lb

torch.set_num_threads(1)

KPAD = 64  # zero bytes on each side of the reversed longer row
COL_BOUND, LIMB_BOUND = 1 << 26, 1 << 27
# compose2's products (La, Lb, L_out) at sec=128, k=128, and K5m's edge
# shapes, as chip_smoke.py checks them on the card
K5M_SHAPES = ((72, 72, 144), (72, 144, 144), (72, 144, 200), (200, 72, 264),
              (136, 136, 264))
K5M_EDGE_SHAPES = ((1, 1, 1), (1, 1, 2), (1, 1, 3), (8, 8, 8), (8, 8, 16),
                   (8, 8, 20), (72, 72, 72), (72, 72, 150), (144, 144, 144),
                   (144, 144, 288), (144, 8, 160), (200, 72, 272), (200, 200, 288),
                   (264, 264, 264), (264, 8, 272), (264, 24, 288), (288, 288, 288),
                   (288, 1, 288), (1, 288, 288), (288, 288, 1))
# the tiles the kernel runs at compose2's shapes (its header)
COMPOSE2_TILES = {(72, 72, 144): 11, (72, 144, 144): 18, (72, 144, 200): 20,
                  (200, 72, 264): 27, (136, 136, 264): 36}
# compose2's products at sec=128, k=256 (L = 160, Lm = 296) and their tiles;
# t1 and sq run the wide instances (L_out past 288)
K256_TILES = {(80, 80, 160): 12, (80, 160, 160): 20, (80, 160, 224): 22,
              (224, 80, 296): 30, (152, 152, 296): 42}

LANE = np.arange(32)
G, Q = LANE >> 2, LANE & 3  # groupID, threadID_in_group


def byte_perm(x, y, sel):
    """__byte_perm: result byte i is byte (sel >> 4 i) & 7 of y:x."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * src)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def funnelshift_r(lo, hi, sh):
    """__funnelshift_r: the low 32 bits of hi:lo >> sh (sh < 32)."""
    both = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((both >> sh.astype(np.uint64)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def _limb(rows, i):
    """Column i of (B, n) uint32 limbs, 0 outside [0, n)."""
    B, n = rows.shape
    ok = (i >= 0) & (i < n)
    return np.where(ok, rows[:, np.clip(i, 0, max(n - 1, 0))], 0).astype(np.uint32)


def n8_tiles(nl, ns, Lo):
    """m-tiles of each n8 tile: ceil(min(2 nl + 31, 2 Lo - 32 J0) / 16)."""
    NT = ((2 * ns + 31) // 32 + 7) // 8
    out = []
    for T in range(NT):
        mend = min(2 * nl + 31, 2 * Lo - 32 * 8 * T)
        out.append((mend + 15) // 16 if mend > 0 else 0)
    return out


def warp_tiles(tiles, wpr):
    """Tiles each of a row's WPR warps takes, as the kernel's loops give
    them out: (T, i) for i from ((wi - before) mod WPR) in steps of WPR."""
    out = [[] for _ in range(wpr)]
    before = 0
    for T, n in enumerate(tiles):
        for wi in range(wpr):
            out[wi] += [(T, i) for i in range((wi - before) % wpr, n, wpr)]
        before += n
    return out


class Model:
    """One launch of K5m on B rows of (B, La) and (B, Lb) int32 limbs."""

    def __init__(self, a, b, Lo):
        La, Lb = a.shape[1], b.shape[1]
        na, nb = min(La, Lo), min(Lb, Lo)
        pl, ps = (a, b) if na >= nb else (b, a)
        self.nl, self.ns, self.Lo = max(na, nb), min(na, nb), Lo
        self.pl = pl[:, :self.nl].astype(np.int64).astype(np.uint32)
        self.ps = ps[:, :self.ns].astype(np.int64).astype(np.uint32)
        self.B = a.shape[0]
        # the 8-bit limbs the kernel reads (low 16 bits of each limb)
        self.l8 = self._bytes(self.pl)
        self.s8 = self._bytes(self.ps)
        self.tiles = n8_tiles(self.nl, self.ns, Lo)

    @staticmethod
    def _bytes(limbs):
        lo = (limbs & 0xFF).astype(np.int64)
        hi = ((limbs >> 8) & 0xFF).astype(np.int64)
        return np.stack([lo, hi], axis=2).reshape(limbs.shape[0], -1)

    def stage(self):
        """The kernel's shared rows, from its own index arithmetic."""
        nl, n8l = self.nl, 2 * self.nl
        w = np.arange((n8l + 2 * KPAD) // 4)
        i = KPAD // 2 + nl - 1 - 2 * w
        self.lng = byte_perm(_limb(self.pl, i), _limb(self.pl, i - 1), 0x4501)
        # the words hold the reversed row between zero pads
        rev = np.ascontiguousarray(self.lng).view(np.uint8).reshape(self.B, -1).astype(np.int64)
        want = np.zeros_like(rev)
        p = KPAD + n8l - 1 - np.arange(n8l)
        want[:, p] = self.l8
        assert np.array_equal(rev, want)
        w = np.arange(64 * len(self.tiles))
        self.sht = byte_perm(_limb(self.ps, 2 * w), _limb(self.ps, 2 * w + 1), 0x5410)

    def tile(self, T, i):
        """Every thread's fragments of tile (T, i), decoded by the PTX
        layout into A (B, 16, 32) and B (B, 32, 8), and the product."""
        J0, m0, n8l = 8 * T, 16 * i, 2 * self.nl
        base = KPAD + n8l - 1 - (m0 + G - 4 * Q)  # (32,)
        w0, sh = base >> 2, 8 * (base & 3)
        L = self.lng
        regs = [funnelshift_r(L[:, w0 + o], L[:, w0 + o + 1], np.broadcast_to(sh, (self.B, 32)))
                for o in (0, -2, 4, 2)]
        A = np.zeros((self.B, 16, 32), dtype=np.int64)
        for r, reg in enumerate(regs):
            row = G + 8 * (r & 1)
            for e in range(4):
                col = 4 * Q + e + 16 * (r >> 1)
                A[:, row, col] = (reg >> (8 * e)) & 0xFF
        Bm = np.zeros((self.B, 32, 8), dtype=np.int64)
        for r, word in enumerate((8 * (J0 + G) + Q, 8 * (J0 + G) + 4 + Q)):
            reg = self.sht[:, word]
            for e in range(4):
                Bm[:, 4 * Q + e + 16 * r, G] = (reg >> (8 * e)) & 0xFF
        # the Toeplitz matrix and the blocks
        m = m0 + np.arange(16)[:, None]
        t = np.arange(32)[None, :]
        x = m - t
        pad = np.concatenate([self.l8, np.zeros((self.B, 64), dtype=np.int64)], axis=1)
        want_A = np.where((x >= 0) & (x < n8l), pad[:, np.clip(x, 0, n8l - 1)], 0)
        assert np.array_equal(A, want_A)
        k = 32 * (J0 + np.arange(8))[None, :] + np.arange(32)[:, None]
        spad = np.concatenate([self.s8, np.zeros((self.B, 32 * 24), dtype=np.int64)], axis=1)
        assert np.array_equal(Bm, spad[:, k])
        return A @ Bm  # (B, 16, 8): P[m0 + row, J0 + col]

    def run(self):
        self.stage()
        Lo = self.Lo
        col = np.zeros((self.B, 2 * Lo), dtype=np.int64)
        for T, n in enumerate(self.tiles):
            for i in range(n):
                C = self.tile(T, i)
                for lane in range(32):
                    g, q = lane >> 2, lane & 3
                    for r in range(4):
                        row, cc = g + 8 * (r >> 1), 2 * q + (r & 1)
                        k = 16 * i + row + 32 * (8 * T + cc)
                        assert k == 16 * i + g + 32 * (8 * T + 2 * q) + 8 * (r >> 1) + 32 * (r & 1)
                        if k < 2 * Lo:
                            col[:, k] += C[:, row, cc]
            # the tiles past the count (up to where A is zero) add nothing
            # below 2 Lo
            for i in range(n, (2 * self.nl + 31 + 15) // 16):
                C = self.tile(T, i)
                k = 16 * i + np.arange(16)[:, None] + 32 * (8 * T + np.arange(8))[None, :]
                assert not C[:, k < 2 * Lo].any()
        self.col = col
        assert (col >= 0).all() and (col < COL_BOUND).all()
        prev = np.concatenate([np.zeros((self.B, 1), dtype=np.int64), col[:, 1:-1:2]], axis=1)
        limbs = col[:, 0::2] + ((col[:, 1::2] & 0xFF) << 8) + (prev >> 8)
        assert (limbs >= 0).all() and (limbs < LIMB_BOUND).all()
        mod = 1 << 16 * Lo
        return [sum(int(v) << 16 * i for i, v in enumerate(row)) % mod for row in limbs.tolist()]


def operands(gen, B, La, Lb):
    """Random limbs of random lengths; edge rows: zero, all-0xFFFF, 1, the
    top limb alone, and limbs with bits above 16 (read as their low 16)."""
    a = np.zeros((B, La), dtype=np.int64)
    b = np.zeros((B, Lb), dtype=np.int64)
    for r in range(B):
        a[r] = gen.integers(0, 1 << 16, size=La) * (np.arange(La) < gen.integers(1, La + 1))
        b[r] = gen.integers(0, 1 << 16, size=Lb) * (np.arange(Lb) < gen.integers(1, Lb + 1))
    fa, fb = np.full(La, 0xFFFF), np.full(Lb, 0xFFFF)
    one_a, one_b = np.eye(1, La, 0)[0], np.eye(1, Lb, 0)[0]
    top_a, top_b = np.eye(1, La, La - 1)[0], np.eye(1, Lb, Lb - 1)[0]
    edge = [(0 * fa, b[0]), (a[1], 0 * fb), (fa, fb), (one_a, fb), (fa, one_b),
            (top_a, top_b), (fa, top_b)]
    for r, (x, y) in enumerate(edge[:B]):
        a[r], b[r] = x, y
    if B > len(edge):  # bits above 16 and negative int32 limbs
        r = len(edge)
        a[r] = gen.integers(-(1 << 31), 1 << 31, size=La)
        b[r] = gen.integers(-(1 << 31), 1 << 31, size=Lb)
    return a.astype(np.int32), b.astype(np.int32)


def check_product(La, Lb, Lo, seed, B=9):
    gen = np.random.default_rng(seed)
    a, b = operands(gen, B, La, Lb)
    model = Model(a, b, Lo)
    got = model.run()
    mask = lambda t: [sum((int(v) & 0xFFFF) << 16 * i for i, v in enumerate(row[:Lo]))  # noqa: E731
                      for row in t.tolist()]
    mod = 1 << 16 * Lo
    assert got == [x * y % mod for x, y in zip(mask(a), mask(b))]
    plain = lb.mag_mul_plain(torch.from_numpy(a & 0xFFFF), torch.from_numpy(b & 0xFFFF), Lo)
    assert lb.limbs_to_ints(plain) == got
    # the columns are the 8-bit convolution below 2 L_out
    conv = np.zeros((B, model.l8.shape[1] + model.s8.shape[1]), dtype=np.int64)
    for r in range(B):
        conv[r, :model.l8.shape[1] + model.s8.shape[1] - 1] = np.convolve(model.l8[r],
                                                                           model.s8[r])
    width = min(2 * Lo, conv.shape[1])
    assert np.array_equal(model.col[:, :width], conv[:, :width])
    assert not model.col[:, width:].any()
    total = sum(model.tiles)
    for wpr in (1, 2, 4):
        split = warp_tiles(model.tiles, wpr)
        assert sorted(t for w in split for t in w) == sorted(
            (T, i) for T, n in enumerate(model.tiles) for i in range(n))
        assert max(len(w) for w in split) == -(-total // wpr)
    return model


@pytest.mark.parametrize("La,Lb,Lo", K5M_SHAPES)
def test_k5m_tiles_at_compose2_shapes(La, Lb, Lo):
    model = check_product(La, Lb, Lo, seed=La * 1000 + Lb * 10 + Lo)
    assert sum(model.tiles) == COMPOSE2_TILES[(La, Lb, Lo)]
    assert max(len(w) for w in warp_tiles(model.tiles, 4)) <= 9


@pytest.mark.parametrize("La,Lb,Lo", K5M_EDGE_SHAPES)
def test_k5m_tiles_at_edge_shapes(La, Lb, Lo):
    check_product(La, Lb, Lo, seed=La * 7 + Lb * 3 + Lo, B=8)


def test_k5m_worst_columns_stay_in_bounds():
    """All-0xFFFF operands of 288 limbs: the fullest column sums 576
    products of 255^2, below 2^26; three n8 tiles, 60 m-tiles."""
    a = np.full((1, 288), 0xFFFF, dtype=np.int32)
    model = Model(a, a.copy(), 288)
    got = model.run()
    assert int(model.col.max()) == 576 * 255 * 255
    assert got == [((1 << 16 * 288) - 1) ** 2 % (1 << 16 * 288)]
    assert model.tiles == [36, 20, 4]


@pytest.mark.parametrize("La,Lb,Lo", sorted(K256_TILES))
def test_k5m_tiles_at_k256_shapes(La, Lb, Lo):
    model = check_product(La, Lb, Lo, seed=La * 1000 + Lb * 10 + Lo, B=4)
    assert sum(model.tiles) == K256_TILES[(La, Lb, Lo)]


def test_k5m_worst_columns_stay_in_bounds_at_320():
    """The wide instances' widest rows: all-0xFFFF operands of 320 limbs
    sum 640 products of 255^2 in the fullest column, still below 2^26;
    three n8 tiles, 72 m-tiles."""
    a = np.full((1, 320), 0xFFFF, dtype=np.int32)
    model = Model(a, a.copy(), 320)
    got = model.run()
    assert int(model.col.max()) == 640 * 255 * 255 < COL_BOUND
    assert got == [((1 << 16 * 320) - 1) ** 2 % (1 << 16 * 320)]
    assert model.tiles == [40, 24, 8]


def test_shapes_are_chip_smokes():
    """The shapes here are the ones chip_smoke.py checks on the card."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_k5m_shapes", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.K5M_SHAPES == K5M_SHAPES
    assert smoke.K5M_EDGE_SHAPES == K5M_EDGE_SHAPES

