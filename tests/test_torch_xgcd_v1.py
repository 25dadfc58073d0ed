"""The port's v1 xgcd (cofhe_tpu_torch.ops.xgcd.xgcd_mod: 13-divstep
groups, Bezout coefficients mod an odd m) against the JAX package's
(cofhe_tpu.ops.xgcd.xgcd_mod), Python's math.gcd and the Bezout identity.

Inputs are the ones of tests/test_xgcd.py's test_random_500b and
test_edges, made from a seeded Random. Tolerance: exact equality of the
canonical outputs d, u, v, and of one group's pieces (divsteps, the
update of f and g, the Bezout update mod m) on redundant limbs.
"""

import random
from math import gcd

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofhe_tpu.ops import limb as jlb
from cofhe_tpu.ops import xgcd as jxgcd
from cofhe_tpu_torch.ops import limb as lb
from cofhe_tpu_torch.ops import xgcd

torch.set_num_threads(1)

_jxgcd = jax.jit(jxgcd.xgcd_mod, static_argnames=("nbits",))


def _check(fs, gs, ms, L, nbits):
    mf, mg, mm = (lb.ints_to_limbs(v, L) for v in (fs, gs, ms))
    got = xgcd.xgcd_mod(*(torch.from_numpy(x) for x in (mf, mg, mm)), nbits)
    want = _jxgcd(jnp.asarray(mf), jnp.asarray(mg), jnp.asarray(mm), nbits)
    for p, j in zip(got, want):
        assert np.array_equal(p.numpy(), np.asarray(j))
    d, u, v = (lb.limbs_to_ints(x) for x in got)
    for i, (f, g, m) in enumerate(zip(fs, gs, ms)):
        assert d[i] == gcd(f, g), i
        assert (u[i] * f + v[i] * g - d[i]) % m == 0, i
        assert 0 <= u[i] < m and 0 <= v[i] < m, i


def test_random_500b_matches_jax():
    rng = random.Random(77)
    B = 48
    fs = [rng.getrandbits(rng.randrange(2, 500)) | 1 for _ in range(B)]
    gs = [rng.getrandbits(rng.randrange(1, 500)) for _ in range(B)]
    ms = [max(rng.getrandbits(rng.randrange(2, 500)) | 1, 3) for _ in range(B)]
    _check(fs, gs, ms, 40, 500)


def test_edges_match_jax():
    rng = random.Random(78)
    m = (1 << 200) + 1  # odd
    f1 = rng.getrandbits(300) | 1
    cases = [
        (f1, 0, m),            # g = 0
        (f1, f1, m),           # equal
        (1, rng.getrandbits(290), m),  # f = 1
        (3, 6, m),
        (f1, f1 * 2, m),       # g multiple of f
        ((1 << 299) + 1, (1 << 298), m),
        (f1, 1, m),
        (5, 0, 5),             # modulus equal gcd
        (f1, rng.getrandbits(300), 3),  # tiny modulus
    ]
    d = rng.getrandbits(80) | 1
    cases.append((d * (rng.getrandbits(100) | 1), d * rng.getrandbits(100), m))
    _check(*(list(c) for c in zip(*cases)), 26, 310)


@pytest.mark.parametrize("W", [1, 5, 8])
def test_group_pieces_match_jax(W):
    """One divstep group, its application to (f, g) and the Bezout update
    mod m, piece by piece, on redundant limbs as the loop carries them."""
    rs = np.random.RandomState(W)
    B, L = 32, 12
    f = rs.randint(0, 1 << 16, size=(B, L)).astype(np.int32)
    f[:, 0] |= 1
    f[:, -2:] = 0
    g = rs.randint(0, 1 << 16, size=(B, L)).astype(np.int32)
    g[:, -2:] = 0
    m = rs.randint(0, 1 << 16, size=(B, L)).astype(np.int32)
    m[:, 0] |= 1
    m[:, W:] = 0
    m[:, W - 1] |= 1
    delta = rs.randint(-5, 6, size=B).astype(np.int32)
    # accumulators as the loop keeps them: |value| < 2m, sign on the limbs
    mv = lb.limbs_to_ints(m)
    Pv = [int(rs.randint(-(1 << 30), 1 << 30)) * x >> 29 for x in mv]
    P = np.sign(Pv).astype(np.int32)[:, None] * lb.ints_to_limbs(Pv, L)
    t = torch.from_numpy
    grp = xgcd._divstep_group(t(delta), t(f[:, 0]), t(g[:, 0]))
    jgrp = jxgcd._divstep_group(jnp.asarray(delta), jnp.asarray(f[:, 0]), jnp.asarray(g[:, 0]))
    for p, j in zip(grp, jgrp):
        assert np.array_equal(p.numpy(), np.asarray(j))
    _, u, v, q, r = grp
    for p, j in zip(xgcd._apply_to_fg(u, v, q, r, t(f), t(g)),
                    jxgcd._apply_to_fg(*jgrp[1:], jnp.asarray(f), jnp.asarray(g))):
        assert np.array_equal(p.numpy(), np.asarray(j))
    # the modulus constants as xgcd_mod builds them, then one Bezout update
    m8, _ = lb._carry_scan(t(m) << 8)
    top = torch.div(lb.mag_bitlen(t(m)) - 1, 16, rounding_mode="floor").clamp(min=0)
    mt = [torch.where(top >= k, lb._limb_at(t(m), top - k), 0).float() for k in range(3)]
    msc = mt[0] + mt[1] * 2.0 ** -16 + mt[2] * 2.0 ** -32
    minv_w = (-lb.modinv16(t(m[:, 0]))) & xgcd.MASK_W
    args = (m8, minv_w, msc, top)
    jargs = [jnp.asarray(x.numpy()) for x in args]
    got = xgcd._apply_bezout_mod(u, v, q, r, t(P), t(P[::-1].copy()), t(m), *args)
    want = jxgcd._apply_bezout_mod(*jgrp[1:], jnp.asarray(P), jnp.asarray(P[::-1].copy()),
                                   jnp.asarray(m), *jargs)
    for p, j in zip(got, want):
        assert np.array_equal(p.numpy(), np.asarray(j))
    # the residues mod m are those of the exact matrix products * 2^-13
    Qv = Pv[::-1]
    gv = [lb.limbs_to_ints(*reversed(lb.canonicalize_fast(x))) for x in got]
    for i in range(B):
        inv = pow(1 << 13, -1, mv[i])
        assert (gv[0][i] - (int(u[i]) * Pv[i] + int(v[i]) * Qv[i]) * inv) % mv[i] == 0
        assert (gv[1][i] - (int(q[i]) * Pv[i] + int(r[i]) * Qv[i]) * inv) % mv[i] == 0
    assert xgcd.iterations_for_bits(500) == jxgcd.iterations_for_bits(500)
