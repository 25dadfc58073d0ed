"""The port's limb and redundant-limb arithmetic (cofhe_tpu_torch.ops.limb,
.rl) against the JAX package's (cofhe_tpu.ops.limb, .rl) and Python ints.

Inputs are the ones of tests/test_limb.py and tests/test_forms2.py:25-66,
made from seeds. Tolerance: exact equality of every canonical integer
output. The one steering estimate checked here (value_est's f32 mantissa)
sums its terms in another order than XLA, so it gets a stated relative
tolerance; its limb index must match exactly.
"""

import random

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
