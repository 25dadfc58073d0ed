"""K1's plain version (cofhe_tpu_torch/ops/xgcd2.py: 30-divstep groups,
the sign-steered safegcd update of the Bezout rows) against the JAX
package's 13-divstep xgcd2.xgcd_coeff_g and its Pallas kernel in interpret
mode, on the CPU.

* Limb for limb, with and without need_u, on the operands of
  tests/test_forms2.py:68-82, on lanes with d > 1 (where cg is not unique
  mod m and only the reference's divstep sequence gives its cg), and at
  the narrow widths 1, 8 and 16.
* Against pallas_group.xgcd_coeff_g(..., interpret=True) on the inputs of
  tests/test_pallas.py:20-38, with d > 1 lanes added.
* A pure-Python divstep oracle: the plain version's per-lane group count
  is ceil(n / 30) for the step n at which g reaches 0.
* One Bezout update on random rows of random signs and edge matrices
  (|u| + |v| = 2^30): rows stay in (-2m, m] and the residue is
  (u X + v Y) 2^-30 mod m.
* On a CUDA card only: the kernel against the plain version on d > 1
  lanes.

Tolerance: exact equality of canonical outputs and of Python integers.
"""

import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofhe_tpu.ops import pallas_group
from cofhe_tpu.ops import xgcd2 as jxgcd2
from cofhe_tpu_torch.ops import cuda_group, xgcd2
from cofhe_tpu_torch.ops import limb as lb

torch.set_num_threads(1)


def _run_both(fs, gs, L, nbits, need_u):
    """The port's plain K1 and the JAX package's xgcd_coeff_g on the same
    limbs (m = f); asserts limb-for-limb equality and the gcd / Bezout
    identities, and returns the port's outputs as Python integers."""
    f_np, g_np = lb.ints_to_limbs(fs, L), lb.ints_to_limbs(gs, L)
    f_t, g_t = torch.from_numpy(f_np), torch.from_numpy(g_np)
    iters = torch.zeros(len(fs), dtype=torch.int32)
    port = xgcd2.xgcd_coeff_g(f_t, g_t, f_t, nbits, need_u=need_u, iters=iters)
    ref = jxgcd2.xgcd_coeff_g(jnp.asarray(f_np), jnp.asarray(g_np),
                              jnp.asarray(f_np), nbits, need_u=need_u)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert np.array_equal(p.numpy(), np.asarray(r))
    out = [lb.limbs_to_ints(t) for t in port]
    for i, (f, g) in enumerate(zip(fs, gs)):
        d, cg = out[0][i], out[1][i]
        assert d == math.gcd(f, g), i
        assert 0 <= cg < f and (cg * g - d) % f == 0, i
        if need_u:
            assert (out[2][i] * f + cg * g - d) % f == 0, i
    return out, iters


def _forms2_operands():
    """tests/test_forms2.py:68-82: 1000-bit lanes and its edge cases."""
    rng = random.Random(7)
    B, bits = 64, 1000
    fs = [rng.randrange(1 << (bits - 1), 1 << bits) | 1 for _ in range(B)]
    gs = [rng.randrange(0, 1 << bits) for _ in range(B)]
    fs[0], gs[0] = 1, 0
    fs[1], gs[1] = 1, 5
    fs[2], gs[2] = 3, 0
    fs[3], gs[3] = 3, 6
    fs[4], gs[4] = (1 << 999) + 1, ((1 << 999) + 1) * 3
    fs[5], gs[5] = 2 ** 999 + 5, 2
    k = rng.randrange(1, 1 << 400) | 1
    fs[6], gs[6] = k * 9, k * 6
    return fs, gs


def _d_gt_1_lanes(bits, n, seed):
    """Lanes whose gcd is above 1: f = g, (9k, 6k), (2^e + 1, 3 (2^e + 1)),
    nudupl-like (a, a) with a odd, and random common odd factors."""
    rng = random.Random(seed)
    fs, gs = [], []
    k = rng.getrandbits(bits // 3) | 1
    a = rng.getrandbits(bits - 2) | (1 << (bits - 3)) | 1
    e = bits - 2
    for f, g in ((a, a), (k * 9, k * 6), ((1 << e) + 1, 3 * ((1 << e) + 1)),
                 (3, 3), (1, 1)):
        fs.append(f)
        gs.append(g)
    while len(fs) < n:
        c = rng.getrandbits(rng.randrange(2, bits // 2)) | 1
        x = rng.getrandbits(bits // 2 - 2) | 1
        y = rng.getrandbits(bits // 2 - 2)
        choice = rng.randrange(3)
        if choice == 0:      # nudupl: the same odd a on both sides
            fs.append(c * x)
            gs.append(c * x)
        elif choice == 1:    # a common odd factor
            fs.append(c * x)
            gs.append(c * y)
        else:                # g a multiple of f
            fs.append(c * x)
            gs.append(c * x * (y % 3 + 1))
    return fs, gs


@pytest.mark.parametrize("need_u", [False, True])
def test_plain_matches_jax_on_forms2_operands(need_u):
    fs, gs = _forms2_operands()
    _run_both(fs, gs, 72, 1010, need_u)


@pytest.mark.parametrize("need_u", [False, True])
def test_plain_matches_jax_on_d_gt_1_lanes(need_u):
    fs, gs = _d_gt_1_lanes(1000, 40, seed=11)
    out, _ = _run_both(fs, gs, 72, 1010, need_u)
    assert sum(d > 1 for d in out[0]) >= 38
    # cg is not unique mod m there: another coefficient also solves the
    # congruence, and the reference's is the one returned
    i = next(i for i, (f, g) in enumerate(zip(fs, gs)) if math.gcd(f, g) > 1 and f > 3)
    d = out[0][i]
    assert (out[1][i] + fs[i] // d) % fs[i] != out[1][i]
    assert ((out[1][i] + fs[i] // d) * gs[i] - d) % fs[i] == 0


@pytest.mark.parametrize("need_u", [False, True])
@pytest.mark.parametrize("L,bits", [(1, 12), (8, 104), (16, 232)])
def test_plain_matches_jax_at_narrow_widths(L, bits, need_u):
    """Widths 8 and 16 with 24 guard bits; one limb, where the top limb is
    also limb 0, with m < 2^12 so that the rows fit it."""
    rng = random.Random(100 + L)
    fs = [rng.getrandbits(rng.randrange(1, bits)) | 1 for _ in range(40)]
    gs = [rng.getrandbits(rng.randrange(1, bits)) for _ in range(40)]
    df, dg = _d_gt_1_lanes(bits, 12, seed=L)
    fs[:12], gs[:12] = df, dg
    fs[12], gs[12] = (1 << (bits - 1)) + 1, 2
    fs[13], gs[13] = 1, 0
    _run_both(fs, gs, L, bits + 8, need_u)


@pytest.mark.skipif(not pallas_group.HAVE_PALLAS, reason="no pallas")
@pytest.mark.parametrize("need_u", [False, True])
def test_plain_matches_pallas_interpret(need_u):
    """tests/test_pallas.py:20-38 (B=6, a ragged batch for the TPU tile),
    with four d > 1 lanes after them."""
    rng = random.Random(23)
    fs = [rng.getrandbits(190) | (1 << 189) | 1 for _ in range(6)]
    gs = [rng.getrandbits(188) for _ in range(6)]
    df, dg = _d_gt_1_lanes(188, 4, seed=5)
    fs, gs = fs + df, gs + dg
    f_np, g_np = lb.ints_to_limbs(fs, 16), lb.ints_to_limbs(gs, 16)
    f_t = torch.from_numpy(f_np)
    port = xgcd2.xgcd_coeff_g(f_t, torch.from_numpy(g_np), f_t, 200, need_u=need_u)
    pall = pallas_group.xgcd_coeff_g(jnp.asarray(f_np), jnp.asarray(g_np),
                                     jnp.asarray(f_np), 200, need_u=need_u,
                                     interpret=True)
    for p, r in zip(port, pall):
        assert np.array_equal(p.numpy(), np.asarray(r))


def _divsteps_to_zero(f, g):
    """The step at which g reaches 0 under the reference's divstep rule
    (delta from 1), on Python integers."""
    delta, n = 1, 0
    while g:
        if delta > 0 and g & 1:
            delta, f, g = 1 - delta, g, (g - f) >> 1
        else:
            delta, g = 1 + delta, (g + (g & 1) * f) >> 1
        n += 1
    return n


def test_group_count_is_ceil_of_divsteps_over_30():
    rng = random.Random(3)
    fs, gs = _forms2_operands()
    fs, gs = fs[:24], gs[:24]
    df, dg = _d_gt_1_lanes(1000, 8, seed=4)
    fs += df + [rng.getrandbits(1000) | 1, 5, 1]
    gs += dg + [1 << 999, 0, 0]
    L = 72
    f_t = torch.from_numpy(lb.ints_to_limbs(fs, L))
    iters = torch.zeros(len(fs), dtype=torch.int32)
    xgcd2.xgcd_coeff_g(f_t, torch.from_numpy(lb.ints_to_limbs(gs, L)), f_t, 1010,
                       iters=iters)
    want = [-(-_divsteps_to_zero(f, g) // xgcd2.STEPS) for f, g in zip(fs, gs)]
    assert iters.tolist() == want
    assert max(want) <= xgcd2.groups_for_bits(1010)
    # the cap covers the safegcd bound the reference rounds to 13-step groups
    for n in (136, 1010, 1152, 1392, 2117):
        assert jxgcd2.iterations_for_bits(n) == 13 * -(-xgcd2.divstep_bound(n) // 13)
        assert xgcd2.groups_for_bits(n) * xgcd2.STEPS >= xgcd2.divstep_bound(n)


def _edge_matrices(rng, n):
    """(u, v) rows with |u| + |v| = 2^30 (and a few below), random signs."""
    top = 1 << xgcd2.STEPS
    rows = [(top, 0), (0, top), (-top, 0), (0, -top), (top // 2, -top // 2),
            (-top // 2, top // 2), (1, 0), (0, 1)]
    while len(rows) < n:
        a = rng.randrange(0, top + 1)
        b = (top - a) if rng.random() < 0.7 else rng.randrange(0, top - a + 1)
        rows.append((a * rng.choice((1, -1)), b * rng.choice((1, -1))))
    return rows[:n]


def test_bezout_update_keeps_rows_in_range():
    """One sign-steered update: for odd m, rows in (-2m, m] and |u| + |v|
    <= 2^30 the result is again in (-2m, m], congruent to (u X + v Y)
    2^-30 mod m; the rows' balanced limbs stay below 2^16 in magnitude."""
    rng = random.Random(17)
    B, L = 400, 20
    ms = [rng.getrandbits(rng.randrange(2, 16 * L - 40)) | 1 for _ in range(B)]
    ms[:4] = [1, 3, (1 << 279) - 1, (1 << 279) + 1]

    def row(m):
        pick = rng.randrange(6)
        edge = (-2 * m + 1, m, -m, 0, -1, m - 1)
        return edge[pick] if rng.random() < 0.3 else rng.randrange(-2 * m + 1, m + 1)

    Xs = [row(m) for m in ms]
    Ys = [row(m) for m in ms]
    uvs, qrs = _edge_matrices(rng, B), _edge_matrices(rng, B)
    rng.shuffle(qrs)

    def limbs(vals):
        s, mag = lb.ints_to_signed(vals, L)
        # balanced, as the loop keeps them
        return xgcd2.rl.carry_pass(torch.from_numpy(s[:, None] * mag))

    m_t = torch.from_numpy(lb.ints_to_limbs(ms, L))
    uv = torch.tensor(uvs, dtype=torch.int64)
    qr = torch.tensor(qrs, dtype=torch.int64)
    Xn, Yn = xgcd2.bezout_update(uv, qr, limbs(Xs), limbs(Ys), m_t, xgcd2.modinv30(m_t))
    for t in (Xn, Yn):
        assert int(t[:, :-1].abs().max()) < 1 << 16
    sx, mx = lb.canonicalize_fast(Xn)
    sy, my = lb.canonicalize_fast(Yn)
    xv = [s * v for s, v in zip(sx.tolist(), lb.limbs_to_ints(mx))]
    yv = [s * v for s, v in zip(sy.tolist(), lb.limbs_to_ints(my))]
    for i, m in enumerate(ms):
        inv = pow(1 << 30, -1, m) if m > 1 else 0
        for new, (a, b) in ((xv[i], uvs[i]), (yv[i], qrs[i])):
            assert -2 * m < new <= m, i
            assert (new - (a * Xs[i] + b * Ys[i]) * inv) % m == 0, i


def test_modinv30():
    rng = random.Random(9)
    ms = [rng.getrandbits(rng.randrange(2, 200)) | 1 for _ in range(60)] + [1, 3, 2 ** 61 - 1]
    got = xgcd2.modinv30(torch.from_numpy(lb.ints_to_limbs(ms, 14))).tolist()
    assert got == [pow(m, -1, 1 << 30) for m in ms]


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_d_gt_1_lanes(cuda_device):
    for L, bits, nbits in ((88, 1300, 1392), (72, 1100, 1152), (8, 96, 136)):
        fs, gs = _d_gt_1_lanes(bits, 133, seed=L)
        f = torch.from_numpy(lb.ints_to_limbs(fs, L)).to(cuda_device)
        g = torch.from_numpy(lb.ints_to_limbs(gs, L)).to(cuda_device)
        for need_u in (False, True):
            it_k = torch.zeros(len(fs), dtype=torch.int32, device=cuda_device)
            it_p = torch.zeros_like(it_k)
            got = cuda_group.xgcd_coeff_g_cuda(f, g, f, nbits, need_u, iters=it_k)
            want = cuda_group.xgcd_coeff_g_plain(f, g, f, nbits, need_u, iters=it_p)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            assert torch.equal(it_k, it_p)
