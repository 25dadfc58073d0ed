"""K6a (cofhe_tpu_torch/csrc/canon_sm.cu): signed sums of limb rows to
canonical sign-magnitude, through its plain version
(cuda_group.canon_sm_plain: the sum in torch ops, then
limb.canonicalize_fast) and the cuda_group dispatcher on CPU tensors, and
a Python model of the kernel's own steps, since it runs only on a card.

Rows come from seeded numpy generators at compose2's widths W = 8, 72,
144 and 264: random two- and three-term sums with signs in {-1, 0, 1},
constant multipliers 1, -1 and 2 and terms narrower than W (zero-extended),
and the edge rows of the contract |value| < 2^(16 W): a carry that
crosses every thread (W - 1 limbs of 0xFFFF plus 1), a sum of exactly 0
(sign 0), negative results (the negation select), a top limb that
carries (a redundant top limb of 2^16 with a borrow from below), and
full rows at W = 264, where each thread holds 9 limbs. Each is held to
a Python-integer oracle and to the JAX package's
limb.canonicalize_fast / sm_add / sm_sub on the same rows (jitted once a
width). The model (thread t holds limbs [t NPT, t NPT + NPT): the
terms' int32 sum, wl::canonicalize_rows as tests/test_torch_kt_chain.py
models it, wl::shr_bits) is held to the plain version at every NPT 1-9.
On a card (`cuda` marker) the kernel is held to the plain version at 128
and 16384 rows. Tolerance: exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofhe_tpu.ops import limb as jlb
from cofhe_tpu_torch.ops import cuda_group
from cofhe_tpu_torch.ops import limb as lb
from test_torch_kt_chain import _rows as kt_rows
from test_torch_kt_chain import canon_row

torch.set_num_threads(1)

WIDTHS = [8, 72, 144, 264]
M32 = (1 << 32) - 1


def _wrap(v: int) -> int:
    """v as an int32 (torch's wrapping arithmetic)."""
    v &= M32
    return v - (1 << 32) if v >> 31 else v


def _limbs(vals, L):
    return torch.from_numpy(lb.ints_to_limbs([abs(v) for v in vals], L))


def _random_sums(gen, W, n, terms):
    """n rows of `terms` signed terms (mag ints, sign ints, L, k) whose sum
    stays inside |value| < 2^(16 W)."""
    out = []
    for t in range(terms):
        L = int(gen.choice([W, max(1, W // 2), 1])) if t else W
        k = int(gen.choice([1, -1, 2])) if t else 1
        bits = 16 * L - 3
        mags = [int.from_bytes(gen.bytes(2 * L), "little") >> (16 * L - bits)
                for _ in range(n)]
        signs = [int(s) for s in gen.integers(-1, 2, n)]
        out.append((mags, signs, L, k))
    return out


def _edge_sums(W):
    """Two-term rows at the contract's edges: (mags, signs, L, k) each."""
    B = 1 << 16
    top = B ** (W - 1)
    rows = [  # (a, sa, b, sb)
        (top - 1, 1, 1, 1),                  # carry across every thread
        (top - 1, 1, top - 1, -1),           # exactly 0
        (0, 0, 0, 1),                        # zero terms
        (1, 1, top * 4, -1),                 # negative: the negation select
        (top, 1, 1, -1),                     # a borrow through every limb
        (B ** W - 1, 1, 0, 0),               # every limb 0xFFFF
        (B ** W - 2, -1, 1, -1),             # -(2^(16 W) - 1)
        (B ** W // 3, 1, B ** W // 3, 1),    # full rows (9 limbs a thread at 264)
        (5, -1, 0, 1),                       # one small negative limb
    ]
    return [([r[0] for r in rows], [r[1] for r in rows], W, 1),
            ([r[2] for r in rows], [r[3] for r in rows], W, 1)]


def _redundant_rows(gen, W):
    """One-term rows of redundant limbs (tests/test_torch_kt_chain.py's:
    +-2^20, the floor passes' edges, negatives) and the top limb that
    carries: 2^16 on top with -1 below, and its negative."""
    edge = [-1] + [0] * (W - 2) + [0x10000]
    return kt_rows(gen, W, 12) + [edge, [-v for v in edge]]


def _row_value(x):
    return sum(v << (16 * i) for i, v in enumerate(x))


def _terms(spec):
    return [(_limbs(m, L), torch.tensor(s, dtype=torch.int32), k)
            for m, s, L, k in spec]


def _oracle(spec, shr=0):
    n = len(spec[0][0])
    vals = [sum(k * s[i] * m[i] for m, s, _, k in spec) for i in range(n)]
    return vals, [abs(v) >> shr for v in vals]


def _redundant(spec, W):
    """The terms' int32 limb sum at width W (the plain version's)."""
    acc = np.zeros((len(spec[0][0]), W), dtype=np.int64)
    for m, s, L, k in spec:
        limbs = lb.ints_to_limbs(m, L).astype(np.int64)[:, :W]
        acc[:, :limbs.shape[1]] += k * np.asarray(s, dtype=np.int64)[:, None] * limbs
    return acc.astype(np.int32)


@pytest.mark.parametrize("W", WIDTHS)
def test_canon_sm_matches_python_and_jax(W):
    gen = np.random.default_rng(1000 + W)
    specs = [_random_sums(gen, W, 24, 2), _random_sums(gen, W, 24, 3), _edge_sums(W)]
    jcanon = jax.jit(jlb.canonicalize_fast)
    jadd, jsub = jax.jit(jlb.sm_add), jax.jit(jlb.sm_sub)
    for spec in specs:
        vals, mags = _oracle(spec)
        sg, mag = cuda_group.canon_sm(_terms(spec), W)
        assert sg.tolist() == [(v > 0) - (v < 0) for v in vals]
        assert lb.limbs_to_ints(mag) == mags
        # the JAX package's canonicalization of the same redundant rows
        js, jm = jcanon(jnp.asarray(_redundant(spec, W)))
        assert np.array_equal(np.asarray(js), sg.numpy())
        assert np.array_equal(np.asarray(jm), mag.numpy())
        if len(spec) == 2 and spec[0][3] == spec[1][3] == 1:
            # sm_add / sm_sub of the two signed magnitudes at width W
            (ma, sa, La, _), (mb, sb, Lb, _) = spec
            a = (jnp.asarray(sa, dtype=jnp.int32),
                 jnp.asarray(lb.ints_to_limbs(ma, W)))
            b = (jnp.asarray(sb, dtype=jnp.int32),
                 jnp.asarray(lb.ints_to_limbs(mb, W)))
            for fn, want in ((jadd, (sg, mag)),
                             (jsub, cuda_group.canon_sm(
                                 [(_limbs(ma, La), torch.tensor(sa, dtype=torch.int32), 1),
                                  (_limbs(mb, Lb), torch.tensor(sb, dtype=torch.int32),
                                   -1)], W))):
                js, jm = fn(a, b)
                assert np.array_equal(np.asarray(js), want[0].numpy())
                assert np.array_equal(np.asarray(jm), want[1].numpy())
    red = _redundant_rows(gen, W)
    x = torch.tensor(red, dtype=torch.int32)
    sg, mag = cuda_group.canon_sm([(x, None, 1)], W)
    vals = [_row_value(r) for r in red]
    assert sg.tolist() == [(v > 0) - (v < 0) for v in vals]
    assert lb.limbs_to_ints(mag) == [abs(v) for v in vals]
    js, jm = jcanon(jnp.asarray(x.numpy()))
    assert np.array_equal(np.asarray(js), sg.numpy())
    assert np.array_equal(np.asarray(jm), mag.numpy())


def test_canon_sm_shift_pair_and_broadcast_row():
    """compose2's forms of the call: b3 with b3 / 2 cut to Lsq limbs, csum
    with |Delta| / 4 as one (1, 2L) row for every lane (cut to Lm), m2x2 as
    2 m2, and two independent sums in one call (the NUCOMP tail)."""
    gen = np.random.default_rng(7)
    L, Lsq, Lm = 144, 136, 264
    spec = _random_sums(gen, L, 32, 2)
    vals, halves = _oracle(spec, shr=1)
    sg, mag, half = cuda_group.canon_sm(_terms(spec), L, shr=1, W_shr=Lsq)
    assert lb.limbs_to_ints(mag) == [abs(v) for v in vals]
    assert lb.limbs_to_ints(half) == [h % (1 << (16 * Lsq)) for h in halves]
    assert torch.equal(half, lb.resize(lb.mag_shr_bits(mag, 1), Lsq))
    d4 = int.from_bytes(gen.bytes(260), "little")
    sq = [int.from_bytes(gen.bytes(2 * Lm - 4), "little") for _ in range(32)]
    row = torch.from_numpy(lb.ints_to_limbs([d4], 2 * L))
    _, csum = cuda_group.canon_sm([(_limbs(sq, Lm), None, 1), (row, None, 1)], Lm)
    assert lb.limbs_to_ints(csum) == [v + d4 for v in sq]
    m2 = [int.from_bytes(gen.bytes(2 * L - 2), "little") for _ in range(32)]
    s2, m2x2 = cuda_group.canon_sm([(_limbs(m2, L), None, 2)], L)
    assert torch.equal(m2x2, lb.mag_shl_bits(_limbs(m2, L), 1, L))
    assert s2.tolist() == [int(v > 0) for v in m2]
    other = _random_sums(gen, L, 32, 3)
    (p_s, p_m), (q_s, q_m) = cuda_group.canon_sm(_terms(spec), L, terms2=_terms(other))
    assert torch.equal(p_s, sg) and torch.equal(p_m, mag)
    ovals, omags = _oracle(other)
    assert q_s.tolist() == [(v > 0) - (v < 0) for v in ovals]
    assert lb.limbs_to_ints(q_m) == omags


def _model(terms, W, shr=0):
    """K6a's steps for one sum on one row of ints (thread t holds limbs
    [t NPT, t NPT + NPT)): (sign, canonical limbs, limbs of mag >> shr)."""
    npt = (W + 31) // 32
    x = [0] * (32 * npt)
    for limbs, s, k in terms:
        sk = _wrap(s * k)
        for i in range(min(len(limbs), W)):
            x[i] = _wrap(x[i] + _wrap(sk * limbs[i]))
    sign, mag = canon_row(x[:W], W)
    mag = list(mag) + [0] * (32 * npt - W)
    # wl::shr_bits: the limb above a thread's last from the next thread
    half = []
    for t in range(32):
        up = mag[(t + 1) * npt] if t < 31 else 0
        for j in range(npt):
            i = t * npt + j
            nxt = mag[i + 1] if j + 1 < npt else up
            half.append((mag[i] >> shr) | ((nxt << (16 - shr)) & 0xFFFF))
    return sign, mag[:W], half[:W]


@pytest.mark.parametrize("npt", range(1, 10))
def test_kernel_model_matches_the_plain_version(npt):
    W = 32 * npt - (npt % 3)  # a full row, and ones that leave limbs spare
    gen = np.random.default_rng(50 + npt)
    for spec in (_random_sums(gen, W, 6, 3), _edge_sums(W)):
        sg, mag, half = cuda_group.canon_sm_plain(_terms(spec), W, shr=1, W_shr=W)
        for r in range(len(spec[0][0])):
            terms = [(lb.ints_to_limbs([m[r]], L)[0].tolist(), s[r], k)
                     for m, s, L, k in spec]
            s_r, m_r, h_r = _model(terms, W, shr=1)
            assert s_r == int(sg[r]) and m_r == mag[r].tolist() and h_r == half[r].tolist()
    red = _redundant_rows(gen, W)
    sg, mag = cuda_group.canon_sm_plain([(torch.tensor(red, dtype=torch.int32), None, 1)], W)
    for r, x in enumerate(red):
        assert _model([(x, 1, 1)], W)[:2] == (int(sg[r]), mag[r].tolist())


def test_dispatcher_routes_by_device():
    """A CPU tensor takes the plain version; the kernel's wrapper refuses
    one (no fallback either way)."""
    gen = np.random.default_rng(3)
    spec = _random_sums(gen, 72, 8, 2)
    terms = _terms(spec)
    before = dict(cuda_group.LAUNCHES)
    got = cuda_group.canon_sm(terms, 72)
    want = cuda_group.canon_sm_plain(terms, 72)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert cuda_group.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_group.canon_sm_cuda(terms, 72)


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6a is a Hopper kernel")
    return torch.device("cuda")


@pytest.mark.cuda
def test_canon_sm_kernel_matches_the_plain_version_on_card(cuda_device):
    for W in WIDTHS:
        for B in (128, 16384):
            gen = np.random.default_rng(W + B)
            for spec in (_random_sums(gen, W, B, 2), _random_sums(gen, W, B, 3),
                         _edge_sums(W)):
                terms = _terms(spec)
                want = cuda_group.canon_sm_plain(terms, W, shr=1, W_shr=W - 1)
                dev = [(m.to(cuda_device), s.to(cuda_device), k) for m, s, k in terms]
                got = cuda_group.canon_sm_cuda(dev, W, shr=1, W_shr=W - 1)
                assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), (W, B)
                pair = cuda_group.canon_sm_cuda(dev, W, terms2=dev[::-1])
                assert all(torch.equal(g.cpu(), w) for g, w in zip(pair[0], want[:2]))
