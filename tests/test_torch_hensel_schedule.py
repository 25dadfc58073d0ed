"""The digit schedule of K5d and K4 (`wl::hensel_steps` in
cofhe_tpu_torch/csrc/warp_limbs.cuh), modelled in Python, since the kernels
run only on a card.

The model keeps what the kernel keeps: a warp of 32 threads, thread t
holding positions [t NPT, t NPT + NPT) of x + Q d as 64-bit sums (numpy
int64, never shifted). Block step o belongs to thread o: it adds the carry
handed over from the block below, takes its block's Montgomery digits one
after another (digit = position mod 2^16 times -d^-1 mod 2^16, folding
each position's carry into the next), and hands the warp its digits and
its last carry; every thread above it adds the products of those digits
with the divisor's limbs within reach (m below the row's significant
limbs) to its positions. K5d's quotient is 2^(16 L_out) - Q, negated limb
by limb (wl::negate_canonical). K4 rows outside `active` take no step;
K4's tail clears the spent positions below steps - 1, splits the sums into
limbs (wl::split_u64) and carries them mod 2^(16 N).

Checked, at every NPT from 1 to 9, at compose2's shapes (K5d's four
quotients, K4's two REDCs at 72 steps) and on edge operands (divisor 1, a
one-limb divisor padded to the full width, all-0xFFFF divisors and
dividends, widths and step counts that are not multiples of NPT, masked
and active rows mixed):
* the digits and R against Python integers and against the plain versions
  (limb.mag_divexact_odd_plain, rl.redc_mod);
* every sum nonnegative and below the bound the kernel states (2^41);
* each position receives exactly the products of the limb-by-limb Hensel
  loop, the divisor's zero limbs above its significant ones aside, and no
  product is taken over those;
* the chain is ceil(steps / NPT) hand-overs, at most ceil(steps / 3) at
  every compose2 shape.
Inputs come from seeded numpy generators. Tolerance: exact equality.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from cofhe_tpu_torch.ops import limb as lb
from cofhe_tpu_torch.ops import rl

torch.set_num_threads(1)

BOUND = 1 << 41  # the kernel's stated bound on a position's sum
# compose2's quotients (Lx, Ly, L_out) and REDCs (Lx, Ld) at sec=128, k=128
K5D_SHAPES = ((144, 144, 72), (144, 72, 144), (144, 72, 72), (264, 264, 144))
K4_SHAPES, K4_STEPS = ((72, 72), (8, 8)), 72


def npt_of(width: int) -> int:
    """Limbs a thread: the launchers' case ceil(width / 32)."""
    return (width + 31) // 32


def modinv16(y0: np.ndarray) -> np.ndarray:
    """wl::modinv16 of odd 16-bit limbs."""
    y = y0.astype(np.int64)
    x = y.copy()
    for _ in range(4):
        x = (x * (2 - y * x)) & 0xFFFF
    return x


class Schedule:
    """One launch of the kernel's digit loop on B rows (one warp each)."""

    def __init__(self, npt: int, steps: int):
        self.npt, self.steps = npt, steps
        self.max_sum = 0
        self.hand_overs = 0

    def _note(self, r):
        assert (r >= 0).all()
        self.max_sum = max(self.max_sum, int(r.max(initial=0)))
        assert self.max_sum < BOUND, "a position's sum left the stated bound"

    def run(self, r, div, nd):
        """r: (B, 32, NPT) int64 sums; div: (B, >= 32 NPT + NPT) int64 limbs,
        zero from nd on; nd: (B,) significant limbs. Returns (digits (B,
        32 NPT), products taken (B, 32 NPT))."""
        npt, steps = self.npt, self.steps
        inv = (0x10000 - modinv16(div[:, 0])) & 0xFFFF  # -d^-1 mod 2^16
        B = r.shape[0]
        q = np.zeros((B, 32 * npt), dtype=np.int64)
        taken = np.zeros((B, 32 * npt), dtype=np.int64)
        dlo = np.where(np.arange(npt)[None, :] < nd[:, None], div[:, :npt], 0)
        cin = np.zeros(B, dtype=np.int64)
        for o in range((steps + npt - 1) // npt):
            self.hand_overs += 1
            p0, n = o * npt, min(npt, steps - o * npt)
            own = r[:, o, :]  # the owner's registers (a view)
            own[:, 0] += cin
            t = np.zeros((B, npt), dtype=np.int64)
            for s in range(n):
                if s:
                    own[:, s] += own[:, s - 1] >> 16
                t[:, s] = ((own[:, s] & 0xFFFF) * inv) & 0xFFFF
                for j in range(s, npt):
                    own[:, j] += t[:, s] * dlo[:, j - s]
                    taken[:, p0 + j] += (j - s) < nd
                    self._note(own)
                q[:, p0 + s] = t[:, s]
            cin = own[:, npt - 1] >> 16  # used by the next owner only
            # threads above the owner, within reach of the divisor
            for lane in range(o + 1, 32):
                base = (lane - o) * npt
                reach = base - (npt - 1) < nd  # (B,) rows whose thread works
                if not reach.any():
                    break
                for j in range(npt):
                    p = lane * npt + j
                    m = base + j - np.arange(npt)  # digit s -> div[m], m >= 1
                    dw = np.where(m[None, :] < nd[:, None], div[:, m], 0)
                    r[:, lane, j] += np.where(reach, (t * dw).sum(axis=1), 0)
                    real = (m[None, :] < nd[:, None]) & (np.arange(npt) < n)[None, :]
                    taken[:, p] += np.where(reach, real.sum(axis=1), 0)
                    self._note(r[:, lane])
        return q, taken


def _limbs(vals, L):
    return lb.ints_to_limbs(vals, L).astype(np.int64)


def _padded_divisor(vals, L, npt):
    """(B, 32 NPT + NPT) limbs and the significant limbs of each row."""
    d = np.zeros((len(vals), 32 * npt + npt), dtype=np.int64)
    d[:, :L] = _limbs(vals, L)
    nd = np.array([(v.bit_length() + 15) // 16 for v in vals], dtype=np.int64)
    return d, nd


def expected_products(nd, steps, npt):
    """Products each position p gets in the limb-by-limb loop, the
    divisor's zero top limbs aside: #{k <= p, k < steps, p - k < nd}
    (positions past the row's width take theirs too, and are not read)."""
    p = np.arange(32 * npt)[None, :]
    lo = np.maximum(0, p - nd[:, None] + 1)
    hi = np.minimum(p, steps - 1)
    return np.maximum(0, hi - lo + 1)


def negate_limbs(q):
    """wl::negate_canonical on (B, W) canonical limbs: 2^(16 W) - q mod
    2^(16 W), limb by limb (zeros below the lowest nonzero limb, 2^16 -
    limb there, 0xFFFF - limb above)."""
    nz = q != 0
    first = np.where(nz.any(axis=1), nz.argmax(axis=1), q.shape[1])[:, None]
    i = np.arange(q.shape[1])[None, :]
    return np.where(i < first, 0, np.where(i == first, 0x10000 - q, 0xFFFF - q))


def model_k5d(xs, ys, Lx, Ly, Lo):
    """The kernel's quotient: x y^-1 mod 2^(16 Lo) as 2^(16 Lo) - Q."""
    npt = npt_of(Lo)
    ny = min(Ly, Lo)
    ymod = [y % (1 << 16 * ny) for y in ys]
    div, nd = _padded_divisor(ymod, ny, npt)
    r = np.zeros((len(xs), 32 * npt), dtype=np.int64)
    r[:, :Lo] = _limbs([x % (1 << 16 * Lo) for x in xs], Lo)
    sched = Schedule(npt, Lo)
    q, taken = sched.run(r.reshape(-1, 32, npt), div, nd)
    assert np.array_equal(taken, expected_products(nd, Lo, npt))
    mod = 1 << 16 * Lo
    Q = [sum(int(d) << 16 * i for i, d in enumerate(row)) for row in q[:, :Lo].tolist()]
    assert Q == [-x * pow(y, -1, mod) % mod for x, y in zip(xs, ymod)]
    return negate_limbs(q[:, :Lo]), sched


def model_k4(xs, ds, act, Lx, Ld, steps):
    """The kernel's REDC: R = (x + Q d) / 2^(16 steps) (Q = 0 on masked
    rows), cut to Lx limbs, then one conditional subtraction of d."""
    N = max(Lx, steps + Ld) + 1
    npt = npt_of(N)
    div, nd = _padded_divisor(ds, Ld, npt)
    r = np.zeros((len(xs), 32 * npt), dtype=np.int64)
    r[:, :Lx] = _limbs(xs, Lx)
    sched = Schedule(npt, steps)
    live = np.array(act, dtype=bool)
    if live.any():  # a masked row takes no digit step
        sub = r[live].reshape(-1, 32, npt)
        _, taken = sched.run(sub, div[live], nd[live])
        assert np.array_equal(taken, expected_products(nd[live], steps, npt))
        r[live] = sub.reshape(-1, 32 * npt)
    r[:, :max(steps - 1, 0)] = 0  # spent sums
    # wl::split_u64: limb i = low 16 bits of s_i + the rest of s_(i-1)
    prev = np.concatenate([np.zeros((len(xs), 1), dtype=np.int64), r[:, :-1]], axis=1)
    v = np.where(np.arange(32 * npt) < N, (r & 0xFFFF) + (prev >> 16), 0)
    assert (v >= 0).all() and (v < 1 << 31).all()
    out = []
    for row, d in zip(v.tolist(), ds):
        R = sum(int(x) << 16 * i for i, x in enumerate(row)) % (1 << 16 * N)
        R = (R >> 16 * steps) % (1 << 16 * Lx)
        out.append(R - d if R >= d else R)
    return out, sched


def k5d_cases(gen, B, Lx, Ly, Lo):
    """Odd y and x: exact multiples on half the rows, any x on the others;
    edge rows: y = 1, a one-limb y, all-0xFFFF y, all-0xFFFF x, x = 0."""
    ymax, xmax = (1 << 16 * Ly) - 1, (1 << 16 * Lx) - 1
    xs, ys = [], []
    for i in range(B):
        wy = int(gen.integers(1, Ly + 1))
        y = int.from_bytes(gen.bytes(2 * wy), "little") | 1
        if i % 2:
            x = (int.from_bytes(gen.bytes(2 * Lo), "little") * y) & xmax
        else:
            x = int.from_bytes(gen.bytes(2 * Lx), "little")
        xs.append(x)
        ys.append(y)
    edge = [(xs[0], 1), (xs[1], 0xFFFF), (xs[2], 3), (xs[3], ymax), (xmax, ymax),
            (xmax, 1), (0, ys[6]), (xmax, (1 << 16 * (Ly - 1)) | 1 if Ly > 1 else 1)]
    for i, (x, y) in enumerate(edge[:B]):
        xs[i], ys[i] = x, y
    return xs, ys


def k4_cases(gen, B, Lx, Ld):
    """Canonical x, odd d, masked and active rows mixed; edge rows: d = 1,
    a one-limb d, all-0xFFFF d and x, x = 0, masked rows with x's top limb
    set and with d = 1."""
    xmax, dmax = (1 << 16 * Lx) - 1, (1 << 16 * Ld) - 1
    xs, ds, act = [], [], []
    for i in range(B):
        wd = int(gen.integers(1, Ld + 1))
        ds.append(int.from_bytes(gen.bytes(2 * wd), "little") | 1)
        xs.append(int.from_bytes(gen.bytes(2 * Lx), "little"))
        act.append(bool(gen.random() < 0.6))
    edge = [(xs[0], 1, True), (xs[1], 0xFFF1, True), (xmax, dmax, True), (0, ds[3], True),
            (xmax, 1, True), (xmax, ds[5], False), (xs[6], 1, False), (xmax, dmax, False)]
    for i, (x, d, a) in enumerate(edge[:B]):
        xs[i], ds[i], act[i] = x, d, a
    return xs, ds, act


def want_k5d(xs, ys, Lo):
    mod = 1 << 16 * Lo
    return [x * pow(y, -1, mod) % mod for x, y in zip(xs, ys)]


def want_k4(xs, ds, act, Lx, steps):
    out = []
    for x, d, a in zip(xs, ds, act):
        Q = -x * pow(d, -1, 1 << 16 * steps) % (1 << 16 * steps) if a and steps else 0
        R = ((x + Q * d) >> 16 * steps) % (1 << 16 * Lx)
        out.append(R - d if R >= d else R)
    return out


def check_k5d(Lx, Ly, Lo, seed, B=12):
    gen = np.random.default_rng(seed)
    xs, ys = k5d_cases(gen, B, Lx, Ly, Lo)
    q, sched = model_k5d(xs, ys, Lx, Ly, Lo)
    got = [sum(int(d) << 16 * i for i, d in enumerate(row)) for row in q.tolist()]
    assert got == want_k5d([x % (1 << 16 * Lo) for x in xs], ys, Lo)
    plain = lb.mag_divexact_odd_plain(torch.from_numpy(lb.ints_to_limbs(xs, Lx)),
                                      torch.from_numpy(lb.ints_to_limbs(ys, Ly)), Lo)
    assert np.array_equal(plain.numpy(), q)
    assert sched.hand_overs == -(-Lo // npt_of(Lo))
    return sched


def check_k4(Lx, Ld, steps, seed, B=12):
    gen = np.random.default_rng(seed)
    xs, ds, act = k4_cases(gen, B, Lx, Ld)
    got, sched = model_k4(xs, ds, act, Lx, Ld, steps)
    assert got == want_k4(xs, ds, act, Lx, steps)
    plain = rl.redc_mod(torch.from_numpy(lb.ints_to_limbs(xs, Lx)),
                        torch.from_numpy(lb.ints_to_limbs(ds, Ld)), steps,
                        active=torch.tensor(act))
    assert lb.limbs_to_ints(plain) == got
    N = max(Lx, steps + Ld) + 1
    assert sched.hand_overs == (-(-steps // npt_of(N)) if any(act) else 0)
    return sched


@pytest.mark.parametrize("Lx,Ly,Lo", K5D_SHAPES)
def test_k5d_schedule_at_compose2_shapes(Lx, Ly, Lo):
    sched = check_k5d(Lx, Ly, Lo, seed=Lx * 1000 + Ly * 10 + Lo)
    assert sched.hand_overs <= -(-Lo // 3)


@pytest.mark.parametrize("Lx,Ld", K4_SHAPES)
def test_k4_schedule_at_compose2_shapes(Lx, Ld):
    sched = check_k4(Lx, Ld, K4_STEPS, seed=Lx * 100 + Ld)
    assert sched.hand_overs <= -(-K4_STEPS // 3)


# every NPT the launchers instantiate, with widths and step counts that are
# and are not multiples of NPT (1, 31, 33, 143, ...)
K5D_WIDTHS = [1, 31, 32, 33, 64, 65, 96, 97, 128, 143, 160, 161, 192, 200, 224, 225, 256,
              257, 288]


@pytest.mark.parametrize("Lo", K5D_WIDTHS)
def test_k5d_schedule_at_every_npt(Lo):
    check_k5d(Lo, Lo, Lo, seed=Lo, B=8)


K4_CASES = [(1, 1, 1), (30, 30, 1), (31, 1, 31), (33, 8, 33), (40, 40, 10), (8, 8, 72),
            (100, 8, 33), (72, 72, 72), (143, 1, 143), (170, 20, 150), (200, 4, 50),
            (250, 30, 100), (143, 143, 143), (72, 72, 215), (287, 72, 143), (16, 8, 263),
            (287, 143, 1)]


@pytest.mark.parametrize("Lx,Ld,steps", K4_CASES)
def test_k4_schedule_at_every_npt(Lx, Ld, steps):
    check_k4(Lx, Ld, steps, seed=Lx * 7 + Ld * 3 + steps, B=8)


def test_k4_masked_rows_take_no_step():
    """A launch whose rows are all masked makes no hand-over and writes
    floor(x / 2^(16 steps)) reduced once by d, also for Lx > steps."""
    gen = np.random.default_rng(9)
    for Lx, Ld, steps in ((72, 72, 72), (8, 8, 72), (100, 8, 33)):
        xs = [int.from_bytes(gen.bytes(2 * Lx), "little") for _ in range(6)]
        ds = [1, 3, (1 << 16 * Ld) - 1, 0xFFFF, 5, 7]
        got, sched = model_k4(xs, ds, [False] * 6, Lx, Ld, steps)
        assert sched.hand_overs == 0 and sched.max_sum == 0
        assert got == want_k4(xs, ds, [False] * 6, Lx, steps)


def test_every_npt_is_covered():
    assert sorted({npt_of(L) for L in K5D_WIDTHS}) == list(range(1, 10))
    assert sorted({npt_of(max(Lx, s + Ld) + 1) for Lx, Ld, s in K4_CASES}) == list(range(1, 10))


def test_shapes_are_chip_smokes():
    """The compose2 shapes here are the ones chip_smoke.py checks on the card."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_shapes", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.K5D_SHAPES == K5D_SHAPES
    assert (smoke.K4_SHAPES, smoke.K4_STEPS) == (K4_SHAPES, K4_STEPS)
