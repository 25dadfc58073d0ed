"""The port's limb and redundant-limb arithmetic (cofhe_tpu_torch.ops.limb,
.rl) against the JAX package's (cofhe_tpu.ops.limb, .rl) and Python ints.

Inputs are the ones of tests/test_limb.py and tests/test_forms2.py:25-66,
made from seeds. Tolerance: exact equality of every canonical integer
output. The one steering estimate checked here (value_est's f32 mantissa)
sums its terms in another order than XLA, so it gets a stated relative
tolerance; its limb index must match exactly.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofhe_tpu.ops import limb as jlb
from cofhe_tpu.ops import rl as jrl
from cofhe_tpu_torch.ops import limb as lb
from cofhe_tpu_torch.ops import rl

torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.int32))


def rand_ints(rng, n, bits, signed=False, allow_zero=True):
    """tests/test_limb.py's generator, on an explicit Random."""
    out = []
    for _ in range(n):
        v = rng.getrandbits(rng.randrange(1, bits + 1))
        if not allow_zero and v == 0:
            v = 1
        if signed and rng.random() < 0.5:
            v = -v
        out.append(v)
    out[0] = 0 if allow_zero else 1
    if n > 2:
        out[1] = (1 << bits) - 1
        out[2] = 1 << (bits - 1)
    return out


def same(port, ref):
    assert np.array_equal(np.asarray(port), np.asarray(ref))


def test_conversions_match_jax():
    rng = random.Random(2024)
    vals = rand_ints(rng, 32, 500, signed=True)
    s, m = lb.ints_to_signed(vals, 40)
    js, jm = jlb.ints_to_signed(vals, 40)
    same(s, js)
    same(m, jm)
    assert lb.limbs_to_ints(T(m), T(s)) == vals == jlb.limbs_to_ints(jm, js)


def test_canonicalize_matches_jax():
    rs = np.random.RandomState(7)
    L = 20
    red = rs.randint(-2**28, 2**28, size=(5, 16, L)).astype(np.int32)
    red[..., -2:] = 0  # |value| < 2^(16 L)
    for r in red:
        ps, pm = lb.canonicalize_fast(T(r))
        js, jm = jlb.canonicalize_fast(jnp.asarray(r))
        same(ps, js)
        same(pm, jm)
        vals = [sum(int(r[i, j]) << (16 * j) for j in range(L)) for i in range(16)]
        assert lb.limbs_to_ints(pm, ps) == vals
    nonneg = np.abs(red[0]) >> 3
    same(lb.canonicalize_nonneg(T(nonneg)), jlb.canonicalize_nonneg(jnp.asarray(nonneg)))


def test_add_sub_cmp_match_jax():
    rng = random.Random(68)
    a = rand_ints(rng, 64, 700, signed=True)
    b = rand_ints(rng, 64, 700, signed=True)
    A = [T(x) for x in lb.ints_to_signed(a, 46)]
    B = [T(x) for x in lb.ints_to_signed(b, 46)]
    jA = [jnp.asarray(x.numpy()) for x in A]
    jB = [jnp.asarray(x.numpy()) for x in B]
    for port, ref, want in ((lb.sm_add, jlb.sm_add, [x + y for x, y in zip(a, b)]),
                            (lb.sm_sub, jlb.sm_sub, [x - y for x, y in zip(a, b)])):
        s, m = port(A, B)
        js, jm = ref(jA, jB)
        same(s, js)
        same(m, jm)
        assert lb.limbs_to_ints(m, s) == want
    ma = [abs(x) for x in a]
    mb = list(ma)
    mb[1:] = [abs(x) for x in b[1:]]  # lane 0 equal
    pa, pb = T(lb.ints_to_limbs(ma, 46)), T(lb.ints_to_limbs(mb, 40 + 6))
    same(lb.mag_cmp(pa, pb), jlb.mag_cmp(jnp.asarray(pa.numpy()), jnp.asarray(pb.numpy())))
    assert lb.mag_cmp(pa, pb).tolist() == [(x > y) - (x < y) for x, y in zip(ma, mb)]


@pytest.mark.parametrize("bits,L,L_out", [(1100, 70, None), (400, 26, 30)])
def test_mag_mul_matches_jax(bits, L, L_out):
    rng = random.Random(bits)
    a = [abs(x) for x in rand_ints(rng, 48, bits)]
    b = [abs(x) for x in rand_ints(rng, 48, bits)]
    ma, mb = lb.ints_to_limbs(a, L), lb.ints_to_limbs(b, L)
    got = lb.mag_mul(T(ma), T(mb), L_out)
    same(got, jlb.mag_mul(jnp.asarray(ma), jnp.asarray(mb), L_out))
    mod = 1 << (16 * (L_out or 2 * L))
    assert lb.limbs_to_ints(got) == [x * y % mod for x, y in zip(a, b)]


def test_shifts_match_jax():
    rng = random.Random(119)
    a = [abs(x) for x in rand_ints(rng, 16, 500)]
    ma = lb.ints_to_limbs(a, 40)
    for bits in (0, 1, 7, 16, 23, 48, 100):
        same(lb.mag_shl_bits(T(ma), bits, 48), jlb.mag_shl_bits(jnp.asarray(ma), bits, 48))
        same(lb.mag_shr_bits(T(ma), bits), jlb.mag_shr_bits(jnp.asarray(ma), bits))
    dyn = np.array([i * 3 % 120 for i in range(16)], dtype=np.int32)
    got = lb.mag_shr_bits_dyn(T(ma), T(dyn))
    same(got, jlb.mag_shr_bits_dyn(jnp.asarray(ma), jnp.asarray(dyn)))
    assert lb.limbs_to_ints(got) == [x >> int(d) for x, d in zip(a, dyn)]
    up = np.array([i * 5 % 100 for i in range(16)], dtype=np.int32)
    m60 = lb.ints_to_limbs(a, 60)
    same(lb.mag_shl_bits_dyn(T(m60), T(up)), jlb.mag_shl_bits_dyn(jnp.asarray(m60), jnp.asarray(up)))


def test_bitlen_float_v2_match_jax():
    rng = random.Random(132)
    a = [abs(x) for x in rand_ints(rng, 64, 900)]
    ma = lb.ints_to_limbs(a, 60)
    same(lb.mag_bitlen(T(ma)), jlb.mag_bitlen(jnp.asarray(ma)))
    assert lb.mag_bitlen(T(ma)).tolist() == [x.bit_length() for x in a]
    for p, j in zip(lb.mag_float(T(ma)), jlb.mag_float(jnp.asarray(ma))):
        same(p, j)
    same(lb.mag_v2(T(ma)), jlb.mag_v2(jnp.asarray(ma)))
    odd = np.array([rng.getrandbits(16) | 1 for _ in range(64)], dtype=np.int32)
    same(lb.modinv16(T(odd)), jlb.modinv16(jnp.asarray(odd)))


def test_divexact_odd_matches_jax():
    rng = random.Random(146)
    qs = [abs(x) for x in rand_ints(rng, 48, 600)]
    ys = [abs(x) | 1 for x in rand_ints(rng, 48, 500, allow_zero=False)]
    mx = lb.ints_to_limbs([q * y for q, y in zip(qs, ys)], 80)
    my = lb.ints_to_limbs(ys, 80)
    got = lb.mag_divexact_odd(T(mx), T(my), 40)
    same(got, jlb.mag_divexact_odd(jnp.asarray(mx), jnp.asarray(my), 40))
    assert lb.limbs_to_ints(got) == qs


def test_rl_helpers_match_jax():
    rs = np.random.RandomState(11)
    x = rs.randint(-2**30, 2**30, size=(32, 24)).astype(np.int32)
    x[:, -2:] = 0
    same(rl.carry_pass(T(x)), jrl.carry_pass(jnp.asarray(x)))
    c2 = rl.carry2(T(x))
    same(c2, jrl.carry2(jnp.asarray(x)))
    j = rs.randint(0, 30, size=32).astype(np.int32)
    same(rl.shl_limbs_take(T(x), T(j)), jrl.shl_limbs_take(jnp.asarray(x), jnp.asarray(j)))
    e = np.arange(-140, 130, dtype=np.int32)
    same(rl.pow2f(T(e)), jrl.pow2f(jnp.asarray(e)))
    f = (rs.standard_normal(64) * 1e5).astype(np.float32)
    f[0] = 0.0
    ft = torch.from_numpy(f)
    same(rl.log2f_i(ft), jrl.log2f_i(jnp.asarray(f)))
    same(rl._log2_f32(ft.abs()), jrl._log2_f32(jnp.abs(jnp.asarray(f))))
    # value_est steers only: the limb index is exact, the f32 mantissa sums
    # its terms in another order (relative difference far below 2^-20)
    pm, pt = rl.value_est(c2)
    jm, jt = jrl.value_est(jnp.asarray(c2.numpy()))
    same(pt, jt)
    np.testing.assert_allclose(pm.numpy(), np.asarray(jm), rtol=2.0 ** -20)
    same(rl.bits_est(torch.tensor(np.asarray(jm)), pt),
         jrl.bits_est(jm, jnp.asarray(pt.numpy())))


def test_mod_topdown_matches_jax():
    """tests/test_forms2.py:25-42 inputs."""
    rng = random.Random(1)
    L, B = 40, 64
    xs = [rng.randrange(-(1 << 500), 1 << 500) for _ in range(B)]
    ms = [rng.randrange(1, 1 << 300) for _ in range(B)]
    xs[0], ms[0] = 0, 1
    xs[1], ms[1] = -1, 1
    xs[2], ms[2] = 12345, 1
    xs[3], ms[3] = -(1 << 400), 3
    xs[4], ms[4] = (1 << 499) + 7, (1 << 499) + 7
    xs[5], ms[5] = (1 << 499) + 6, (1 << 499) + 7
    xs[6], ms[6] = -((1 << 499) + 8), (1 << 499) + 7
    sx, mx = lb.ints_to_signed(xs, L + 4)
    x = sx[:, None] * mx
    mm = lb.ints_to_limbs(ms, L)
    got = rl.mod_topdown(T(x), T(mm), max_iters=600)
    same(got, jrl.mod_topdown(jnp.asarray(x), jnp.asarray(mm), max_iters=600))
    assert lb.limbs_to_ints(got) == [x_ % m_ for x_, m_ in zip(xs, ms)]


def test_redc_pow16_matches_jax():
    """tests/test_forms2.py:45-65 inputs: the same residue mod d as the JAX
    REDC, inside [0, 2d)."""
    rng = random.Random(2)
    L, B, K = 40, 64, 30
    ss = [rng.randrange(0, 1 << 450) for _ in range(B)]
    ds = [rng.randrange(1, 1 << 100) | 1 for _ in range(B)]
    ds[0] = 1
    s_l, dL = lb.ints_to_limbs(ss, L), lb.ints_to_limbs(ds, L)
    d8L = lb.ints_to_limbs([d << 8 for d in ds], L)
    jout = jrl.redc_pow16(jnp.asarray(s_l), jnp.asarray(dL), jnp.asarray(d8L),
                          jlb.modinv16(jnp.asarray(dL)[:, 0]), steps=K)
    js, jm = jlb.canonicalize_fast(jout)
    want = [int(a) * b for a, b in zip(np.asarray(js), jlb.limbs_to_ints(jm))]
    ps, pm = lb.canonicalize_fast(rl.redc_pow16(T(s_l), T(dL), steps=K))
    got = lb.limbs_to_ints(pm, ps)
    for i in range(B):
        assert got[i] % ds[i] == want[i] % ds[i], i
        assert 0 <= got[i] < 2 * ds[i], i
        if ds[i] > 1:
            assert got[i] % ds[i] == ss[i] * pow(1 << (16 * K), -1, ds[i]) % ds[i]


# ----------------------------------- the limb functions of the v1 composition


def test_canonicalize_scan_matches_jax():
    """tests/test_limb.py:57 cases: the sequential carry scan and
    canonicalize, against the JAX functions, Python ints and
    canonicalize_fast; mag_is_zero on the results."""
    rs = np.random.RandomState(57)
    L = 20
    for _ in range(5):
        red = rs.randint(-2**28, 2**28, size=(16, L)).astype(np.int32)
        red[:, -2:] = 0  # |value| < 2^(16 L)
        red[3] = 0
        for p, j in zip(lb._carry_scan(T(red)), jlb._carry_scan(jnp.asarray(red))):
            same(p, j)
        ps, pm = lb.canonicalize(T(red))
        js, jm = jax.jit(jlb.canonicalize)(jnp.asarray(red))
        same(ps, js)
        same(pm, jm)
        vals = [sum(int(red[i, j]) << (16 * j) for j in range(L)) for i in range(16)]
        assert lb.limbs_to_ints(pm, ps) == vals
        for p, f in zip((ps, pm), lb.canonicalize_fast(T(red))):
            same(p, f)
        same(lb.mag_is_zero(pm), jlb.mag_is_zero(jm))
        assert lb.mag_is_zero(pm).tolist() == [v == 0 for v in vals]


def test_sm_neg_cmp_redundant_match_jax():
    """tests/test_limb.py:68 cases: sm_cmp, sm_neg and sm_redundant."""
    rng = random.Random(68)
    a = rand_ints(rng, 64, 700, signed=True)
    b = rand_ints(rng, 64, 700, signed=True)
    b[5] = a[5]
    A = [T(x) for x in lb.ints_to_signed(a, 46)]
    B = [T(x) for x in lb.ints_to_signed(b, 46)]
    jA = [jnp.asarray(x.numpy()) for x in A]
    jB = [jnp.asarray(x.numpy()) for x in B]
    c = lb.sm_cmp(A, B)
    same(c, jax.jit(jlb.sm_cmp)(jA, jB))
    assert c.tolist() == [(x > y) - (x < y) for x, y in zip(a, b)]
    ns, nm = lb.sm_neg(A)
    for p, j in zip((ns, nm), jlb.sm_neg(jA)):
        same(p, j)
    assert lb.limbs_to_ints(nm, ns) == [-x for x in a]
    red = lb.sm_redundant(A)
    same(red, jlb.sm_redundant(jA))
    assert lb.limbs_to_ints(*reversed(lb.canonicalize_fast(red))) == a


@pytest.mark.parametrize("L_out", [None, 40])
def test_sm_mul_sqr_match_jax(L_out):
    """tests/test_limb.py:102 cases: sm_mul, and mag_sqr on |a|."""
    rng = random.Random(102)
    a = rand_ints(rng, 32, 400, signed=True)
    b = rand_ints(rng, 32, 400, signed=True)
    A = [T(x) for x in lb.ints_to_signed(a, 26)]
    B = [T(x) for x in lb.ints_to_signed(b, 26)]
    jA = [jnp.asarray(x.numpy()) for x in A]
    jB = [jnp.asarray(x.numpy()) for x in B]
    s, m = lb.sm_mul(A, B, L_out)
    js, jm = jlb.sm_mul(jA, jB, L_out)
    same(s, js)
    same(m, jm)
    mod = 1 << (16 * (L_out or 52))
    assert lb.limbs_to_ints(m, s) == [(abs(x * y) % mod) * ((x * y > 0) - (x * y < 0))
                                      for x, y in zip(a, b)]
    sq = lb.mag_sqr(A[1], L_out)
    same(sq, jlb.mag_sqr(jA[1], L_out))
    assert lb.limbs_to_ints(sq) == [x * x % mod for x in a]


@pytest.mark.parametrize("L_out", [None, 44])
def test_sm_scalar_mul_matches_jax(L_out):
    """tests/test_limb.py:111 cases."""
    rng = random.Random(111)
    a = rand_ints(rng, 32, 600, signed=True)
    sc = np.array([rng.randrange(-2**14, 2**14) for _ in range(32)], dtype=np.int32)
    sc[3] = 0
    A = [T(x) for x in lb.ints_to_signed(a, 42)]
    s, m = lb.sm_scalar_mul(A, T(sc), L_out)
    js, jm = jlb.sm_scalar_mul([jnp.asarray(x.numpy()) for x in A], jnp.asarray(sc), L_out)
    same(s, js)
    same(m, jm)
    assert lb.limbs_to_ints(m, s) == [x * int(y) for x, y in zip(a, sc)]


def test_shr_limbs_shl8_digit_estimate_match_jax():
    rng = random.Random(399)
    a = [abs(x) for x in rand_ints(rng, 32, 600)]
    ma = lb.ints_to_limbs(a, 40)
    for n in (0, 1, 5, 39):
        same(lb.mag_shr_limbs(T(ma), n), jlb.mag_shr_limbs(jnp.asarray(ma), n))
        assert lb.limbs_to_ints(lb.mag_shr_limbs(T(ma), n)) == [x >> (16 * n) for x in a]
    same(lb._shl8(T(ma), 40), jlb._shl8(jnp.asarray(ma), 40))
    assert lb.limbs_to_ints(lb._shl8(T(ma), 40)) == [x << 8 for x in a]
    # the digit estimate at every shift a 1200-bit by 700-bit division takes
    b = [max(abs(x), 1) for x in rand_ints(rng, 32, 300, allow_zero=False)]
    xm, xe = lb.mag_float(T(ma))
    ym, ye = lb.mag_float(T(lb.ints_to_limbs(b, 40)))
    jx = [jnp.asarray(v.numpy()) for v in (xm, xe)]
    jy = [jnp.asarray(v.numpy()) for v in (ym, ye)]
    for shift in range(0, 40 * 16, 16):
        same(lb._div_digit_estimate(xm, xe, ym, ye, shift),
             jlb._div_digit_estimate(*jx, *jy, shift))


_jdivmod = jax.jit(jlb.mag_divmod, static_argnames=("Lq",))


def _divmod_case(xs, ys, L, Lq):
    mx, my = lb.ints_to_limbs(xs, L), lb.ints_to_limbs(ys, L)
    q, r = lb.mag_divmod(T(mx), T(my), Lq)
    jq, jr = _jdivmod(jnp.asarray(mx), jnp.asarray(my), Lq)
    same(q, jq)
    same(r, jr)
    assert lb.limbs_to_ints(q) == [x // y for x, y in zip(xs, ys)]
    assert lb.limbs_to_ints(r) == [x % y for x, y in zip(xs, ys)]
    same(lb.mag_mod(T(mx), T(my), Lq), jr)


def test_divmod_matches_jax():
    """tests/test_limb.py:156 cases."""
    rng = random.Random(156)
    xs = [abs(x) for x in rand_ints(rng, 64, 1200)]
    ys = [max(abs(y), 1) for y in rand_ints(rng, 64, 700, allow_zero=False)]
    _divmod_case(xs, ys, 80, (1200 - 1) // 16 + 2)


def test_divmod_adversarial_matches_jax():
    """tests/test_limb.py:171 cases: x = q*y + {0, 1, y-1}."""
    rng = random.Random(171)
    cases = []
    for _ in range(40):
        y = rng.getrandbits(rng.randrange(2, 500)) + 1
        q = rng.getrandbits(rng.randrange(1, 500))
        for r in (0, 1, y - 1):
            cases.append((q * y + r, y))
    L = (1000 // 16) + 4
    _divmod_case([c[0] for c in cases], [c[1] for c in cases], L, L)
