"""K5m, K5d and K4: their plain versions (the route a CPU tensor takes)
against the JAX package's functions they replace and against Python
integers, at compose2's widths for sec=128, k=128 (L=144, Lh=72, Lu=200,
Lm=264, Lsq=136), and the routes of their dispatchers.

* K5m `cuda_group.mag_mul` (plain: limb.mag_mul_plain) vs
  cofhe_tpu.ops.limb.mag_mul and a * b mod 2^(16 L_out), at compose2's
  seven products' shapes and at widths 1 to 288 with L_out below, at and
  above La + Lb, on zero and all-0xFFFF operands.
* K5d `cuda_group.mag_divexact_odd` (plain: limb.mag_divexact_odd_plain)
  vs cofhe_tpu.ops.limb.mag_divexact_odd (the Hensel scan) and
  x * y^-1 mod 2^(16 L_out), at compose2's four quotients' shapes; y = 1,
  x = 0, y of one limb and quotients that fill L_out.
* K4 `cuda_group.redc_mod` (plain: rl.redc_mod) vs cofhe_tpu.ops.rl.
  redc_pow16 (steps = Lh = 72) followed by compose2's subtraction, and
  x * 2^(-16 Lh) mod d, with x and d of 8 and of 72 limbs; d = 1, d of
  one limb, inactive lanes (floor(x / 2^(16 Lh)) reduced once by d) and
  x with its top limb set.

Every dispatcher built from cuda_group.DISPATCH, one case a kernel,
routes a CPU tensor to its plain version and any other to its CUDA
wrapper.

The kernels themselves run only on a card: tests/test_torch_kernels.py
holds them to these plain versions there. Inputs come from seeded
Randoms. Tolerance: exact equality.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofhe_tpu.ops import limb as jlb
from cofhe_tpu.ops import rl as jrl
from cofhe_tpu_torch.ops import cuda_group
from cofhe_tpu_torch.ops import limb as lb
from cofhe_tpu_torch.ops import rl
from cofhe_tpu_torch.ops.forms import BForm

torch.set_num_threads(1)

LH = 72
# compose2's products (La, Lb, L_out), quotients (Lx, Ly, L_out), REDCs (Lx, Ld)
PRODUCTS = [(72, 72, 144), (72, 144, 144), (144, 72, 144), (72, 144, 200),
            (200, 72, 264), (136, 136, 264), (144, 144, 144), (72, 72, None)]
QUOTIENTS = [(144, 144, 72), (144, 72, 144), (144, 72, 72), (264, 264, 144)]
REDCS = [(72, 72), (8, 8)]


def _limbs(vals, L):
    return lb.ints_to_limbs(vals, L)


def _products(rng, n, La, Lb):
    """n (a, b) pairs: random widths, then zero operands, all-0xFFFF limbs,
    1 and lone top limbs."""
    fa, fb = (1 << 16 * La) - 1, (1 << 16 * Lb) - 1
    pairs = [(0, fb), (fa, 0), (fa, fb), (1, fb), (1 << 16 * (La - 1), 1 << 16 * (Lb - 1))]
    pairs += [(rng.getrandbits(rng.randrange(1, 16 * La + 1)),
               rng.getrandbits(rng.randrange(1, 16 * Lb + 1))) for _ in range(n - len(pairs))]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("La,Lb,Lo", PRODUCTS)
def test_k5m_plain_matches_jax_and_integers(La, Lb, Lo):
    """Equal to the JAX product on every lane where that is exact: all but
    the all-0xFFFF lane once both operands pass 129 limbs (below). L_out
    None is La + Lb, as the NUCOMP tail and the v1 code call it."""
    rng = random.Random(La * 1000 + Lb * 7 + (Lo or 0))
    a, b = _products(rng, 12, La, Lb)
    ma, mb = _limbs(a, La), _limbs(b, Lb)
    got = cuda_group.mag_mul(torch.from_numpy(ma), torch.from_numpy(mb), Lo)
    assert got.shape == (12, Lo or La + Lb)
    mod = 1 << (16 * (Lo or La + Lb))
    want = [x * y % mod for x, y in zip(a, b)]
    assert lb.limbs_to_ints(got) == want
    jgot = np.asarray(jlb.mag_mul(jnp.asarray(ma), jnp.asarray(mb), Lo))
    jax_wrong = [i for i, v in enumerate(lb.limbs_to_ints(jgot)) if v != want[i]]
    assert jax_wrong == ([2] if min(La, Lb) > 129 else [])
    keep = [i for i in range(len(a)) if i not in jax_wrong]
    assert np.array_equal(got.numpy()[keep], jgot[keep])


def test_jax_mag_mul_chunk_sum_fault_pinned():
    """The JAX product sums its 256-tap float32 convolution chunks in
    float32: once both operands pass 129 limbs a dense column's sum passes
    2^24 and rounds (cofhe_tpu/ops/limb.py:330-349). The port's plain
    version (a float64 FFT) and K5m are exact there."""
    for L in (129, 136):
        f = (1 << 16 * L) - 1
        m = _limbs([f], L)
        jv = lb.limbs_to_ints(np.asarray(jlb.mag_mul(jnp.asarray(m), jnp.asarray(m), 2 * L)))
        pv = lb.limbs_to_ints(cuda_group.mag_mul(torch.from_numpy(m), torch.from_numpy(m),
                                                 2 * L))
        assert pv == [f * f]
        assert (jv == [f * f]) == (L <= 129)


@pytest.mark.parametrize("La,Lb,Lo", [(1, 1, 1), (1, 1, 3), (8, 8, 16), (8, 8, 20),
                                      (72, 72, 150), (144, 8, 160), (200, 200, 288),
                                      (264, 24, 288), (288, 288, 288), (288, 1, 288),
                                      (288, 288, 1)])
def test_k5m_plain_edge_widths_match_integers(La, Lb, Lo):
    """Widths 1 to 288, L_out below, at and above La + Lb."""
    rng = random.Random(La + 3 * Lb + 11 * Lo)
    a, b = _products(rng, 10, La, Lb)
    got = cuda_group.mag_mul(torch.from_numpy(_limbs(a, La)),
                             torch.from_numpy(_limbs(b, Lb)), Lo)
    mod = 1 << (16 * Lo)
    assert got.shape == (10, Lo)
    assert lb.limbs_to_ints(got) == [x * y % mod for x, y in zip(a, b)]


def _quotients(rng, n, Lx, Ly, Lo):
    """n (x, y) pairs, y odd: y = 1 with x = 0 and any x, y of one limb,
    quotients that fill L_out (all 0xFFFF), then exact multiples q * y
    and any x in turn."""
    full_q, top = (1 << 16 * Lo) - 1, 1 << 16 * Lx
    small = rng.getrandbits(15) | (1 << 15) | 1
    pairs = [(0, 1), (rng.getrandbits(16 * Lx), 1), (0, (rng.getrandbits(16 * Ly) | 1)),
             (full_q, 1), (full_q * small % top, small), (rng.getrandbits(16 * Lx), small)]
    while len(pairs) < n:
        y = rng.getrandbits(rng.randrange(1, 16 * Ly + 1)) | 1
        if len(pairs) % 2:
            room = min(16 * Lx - y.bit_length(), 16 * Lo)
            pairs.append((rng.getrandbits(rng.randrange(0, room + 1)) * y, y))
        else:
            pairs.append((rng.getrandbits(rng.randrange(1, 16 * Lx + 1)), y))
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("Lx,Ly,Lo", QUOTIENTS)
def test_k5d_plain_matches_jax_and_integers(Lx, Ly, Lo):
    rng = random.Random(Lx * 1000 + Ly * 7 + Lo)
    xs, ys = _quotients(rng, 12, Lx, Ly, Lo)
    mx, my = _limbs(xs, Lx), _limbs(ys, Ly)
    got = cuda_group.mag_divexact_odd(torch.from_numpy(mx), torch.from_numpy(my), Lo)
    # the JAX scan takes y at the dividend's width
    want = jlb.mag_divexact_odd(jnp.asarray(mx), jnp.asarray(_limbs(ys, Lx)), Lo)
    assert np.array_equal(got.numpy(), np.asarray(want))
    mod = 1 << (16 * Lo)
    vals = lb.limbs_to_ints(got)
    assert vals == [x * pow(y, -1, mod) % mod for x, y in zip(xs, ys)]
    assert all(v == (x // y) % mod for v, x, y in zip(vals, xs, ys) if x % y == 0)
    # compose2's shared-inverse route gives the same quotients
    inv = lb.inv_pow2(torch.from_numpy(my), Lo)
    assert torch.equal(cuda_group.mag_divexact_odd(torch.from_numpy(mx),
                                                   torch.from_numpy(my), Lo, inv=inv), got)


def _redcs(rng, n, Lx, Ld):
    """n (x, d, active) lanes, d odd: d = 1, d of one limb, all-0xFFFF d, x
    with its top limb set, x = 0, x = d - 1, x = d, inactive lanes with d = 1
    (as compose2's masks leave them) or any odd d, then random lanes."""
    top = (0xFFFF << 16 * (Lx - 1)) | rng.getrandbits(16 * (Lx - 1))
    one = rng.getrandbits(15) | (1 << 15) | 1
    dmax = (1 << 16 * Ld) - 1
    d0 = rng.getrandbits(16 * Ld) | 1
    lanes = [(rng.getrandbits(16 * Lx), 1, True), (rng.getrandbits(16 * Lx), one, True),
             (rng.getrandbits(16 * Lx), dmax, True), (top, d0, True), (0, d0, True),
             (d0 - 1, d0, True), (d0, d0, True), (top, dmax, True),
             (rng.getrandbits(16 * Lx), 1, False), (top, d0, False), (top, 1, False)]
    while len(lanes) < n:
        lanes.append((rng.getrandbits(rng.randrange(1, 16 * Lx + 1)),
                      rng.getrandbits(rng.randrange(1, 16 * Ld + 1)) | 1,
                      rng.random() < 0.75))
    return tuple(list(x) for x in zip(*lanes))


@pytest.mark.parametrize("Lx,Ld", REDCS)
def test_k4_plain_matches_jax_and_integers(Lx, Ld):
    rng = random.Random(Lx * 100 + Ld)
    xs, ds, act = _redcs(rng, 16, Lx, Ld)
    mx, md = _limbs(xs, Lx), _limbs(ds, Ld)
    active = torch.tensor(act)
    got = cuda_group.redc_mod(torch.from_numpy(mx), torch.from_numpy(md), LH, active)
    # the JAX loop, then compose2's canonicalization and subtraction of d,
    # one limb wider so that d << 8 fits for every d
    jd = jnp.asarray(_limbs(ds, Lx + 1))
    jd8 = jnp.asarray(_limbs([d << 8 for d in ds], Lx + 1))
    jout = jrl.redc_pow16(jnp.asarray(_limbs(xs, Lx + 1)), jd, jd8,
                          jlb.modinv16(jd[:, 0]), steps=LH, active=jnp.asarray(act))
    _, jm = jlb.canonicalize_fast(jout)
    ge = jlb.mag_cmp(jm, jd) >= 0
    _, jm = jlb.canonicalize_fast(jm - jnp.where(ge[..., None], jd, 0))
    jm = np.asarray(jm)
    assert not jm[:, Lx].any()
    assert np.array_equal(got.numpy(), jm[:, :Lx])
    want = [x * pow(2, -16 * LH, d) % d if a else
            ((x >> 16 * LH) - d if (x >> 16 * LH) >= d else x >> 16 * LH)
            for x, d, a in zip(xs, ds, act)]
    assert lb.limbs_to_ints(got) == want
    # with compose2's shared inverse on the CPU route
    inv = lb.inv_pow2(torch.from_numpy(md), LH)
    assert torch.equal(cuda_group.redc_mod(torch.from_numpy(mx), torch.from_numpy(md),
                                           LH, active, inv), got)


def test_dispatchers_route_cpu_to_plain_and_refuse_other_devices(monkeypatch):
    """A CPU tensor takes the plain version and launches nothing; limb.
    mag_mul / mag_divexact_odd go through the dispatchers; a meta tensor
    reaches the CUDA wrapper, which refuses it."""
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached a CUDA wrapper")

    for name in ("mag_mul_cuda", "mag_divexact_odd_cuda", "redc_mod_cuda"):
        monkeypatch.setattr(cuda_group, name, refuse)
    before = dict(cuda_group.LAUNCHES)
    a = torch.from_numpy(_limbs([3 << 40, 12345], 4))
    b = torch.from_numpy(_limbs([5, (1 << 64) - 1], 4))
    assert lb.limbs_to_ints(lb.mag_mul(a, b, 6)) == [15 << 40, 12345 * ((1 << 64) - 1)]
    assert lb.limbs_to_ints(lb.mag_divexact_odd(lb.mag_mul(a, b, 8), b, 4)) == \
        lb.limbs_to_ints(a)
    d = torch.from_numpy(_limbs([7, 1 << 40 | 1], 4))
    r = cuda_group.redc_mod(a, d, 4)
    assert lb.limbs_to_ints(r) == [(3 << 40) * pow(2, -64, 7) % 7,
                                   12345 * pow(2, -64, 1 << 40 | 1) % (1 << 40 | 1)]
    assert cuda_group.LAUNCHES == before
    monkeypatch.undo()
    meta = a.to("meta")
    for call in (lambda: cuda_group.mag_mul(meta, meta, 6),
                 lambda: cuda_group.mag_divexact_odd(meta, meta, 4),
                 lambda: cuda_group.redc_mod(meta, meta, 4),
                 lambda: lb.mag_mul(meta, meta, 6)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert cuda_group.LAUNCHES == before


def _routed_args(kernel: str, t) -> tuple:
    """Positional arguments for `kernel`'s dispatcher with `t` where the
    dispatch table reads the route: a K6a sum's first term, K6b's F1.a,
    else the first argument."""
    if kernel == "canon_sm":
        return ([(t, None, 1)], 4)
    if kernel == "compose_prologue":
        return (BForm(t, t[:, 0], t, t),) * 2
    return (t, t)


@pytest.mark.parametrize("kernel", cuda_group.KERNELS)
def test_dispatch_table_routes_each_kernel(kernel, monkeypatch):
    """Each dispatcher built from cuda_group.DISPATCH hands its arguments
    to <name>_plain when a CPU tensor is in its route position and to
    <name>_cuda when a meta tensor is, and returns what that gave; both
    are read from the module at the call."""
    name = cuda_group.DISPATCH[kernel].name
    seen = []
    for side in ("plain", "cuda"):
        monkeypatch.setattr(cuda_group, f"{name}_{side}",
                            lambda *a, _side=side, **k: seen.append((_side, a, k)) or _side)
    for dev, side in (("cpu", "plain"), ("meta", "cuda")):
        args = _routed_args(kernel, torch.zeros((2, 4), dtype=torch.int32, device=dev)) + (7,)
        assert getattr(cuda_group, name)(*args, extra=1) == side
        got_side, got_args, got_kw = seen[-1]
        assert got_side == side and got_kw == {"extra": 1}
        assert len(got_args) == len(args) and all(x is y for x, y in zip(got_args, args))
    assert len(seen) == 2


def test_dispatch_table_names_every_kernel_and_its_dispatcher():
    """The table holds one entry for each kernel that build() compiles, in
    its order, and each entry's dispatcher is the module attribute of its
    name, with its plain version and CUDA wrapper beside it."""
    assert tuple(cuda_group.DISPATCH) == cuda_group.KERNELS
    assert len({d.name for d in cuda_group.DISPATCH.values()}) == len(cuda_group.KERNELS)
    for kernel, d in cuda_group.DISPATCH.items():
        fn = getattr(cuda_group, d.name)
        assert fn.__name__ == d.name and f"{d.label} `{kernel}`" in fn.__doc__
        assert callable(getattr(cuda_group, d.name + "_plain"))
        assert callable(getattr(cuda_group, d.name + "_cuda"))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """No fallback: widths past 320 limbs (the wide instances' bound), L_out
    above the dividend, d wider than x and mismatched rows raise before
    any launch."""
    with pytest.raises(ValueError, match="CUDA"):
        cuda_group.mag_mul_cuda(torch.zeros(2, 4, dtype=torch.int32),
                                torch.zeros(2, 4, dtype=torch.int32))
    big = torch.empty((2, 321), dtype=torch.int32, device="meta")
    small = torch.empty((2, 8), dtype=torch.int32, device="meta")
    three = torch.empty((3, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="outside"):
        cuda_group.mag_mul_cuda(big, small, 100)
    with pytest.raises(ValueError, match="outside"):
        cuda_group.mag_mul_cuda(small, small, 321)
    with pytest.raises(ValueError, match="do not broadcast"):
        cuda_group.mag_mul_cuda(small, three, 8)
    with pytest.raises(ValueError, match="do not broadcast"):
        cuda_group.mag_divexact_odd_cuda(small, three, 8)
    with pytest.raises(ValueError, match="exceeds"):
        cuda_group.mag_divexact_odd_cuda(small, small, 9)
    with pytest.raises(ValueError, match="Ld <= Lx"):
        cuda_group.redc_mod_cuda(small, big, 72)
    with pytest.raises(ValueError, match="Ld <= Lx"):
        cuda_group.redc_mod_cuda(small[:, :4], small, 72)
    with pytest.raises(ValueError, match="Ld <= Lx"):
        cuda_group.redc_mod_cuda(small, small, 280)


def test_dispatchers_broadcast_leading_shapes():
    """Both routes take operands whose leading shapes broadcast, as the
    plain products do: the plain route gives the broadcast products and
    quotients, and the CUDA wrappers get past their shape checks (a meta
    tensor then stops at the device check)."""
    rng = random.Random(8)
    av = [rng.getrandbits(64) for _ in range(6)]
    bv = [rng.getrandbits(48) | 1 for _ in range(2)]
    a = torch.from_numpy(_limbs(av, 4)).reshape(3, 2, 4)
    b = torch.from_numpy(_limbs(bv, 3))
    prod = lb.mag_mul(a, b, 6)
    assert prod.shape == (3, 2, 6)
    assert lb.limbs_to_ints(prod.reshape(6, 6)) == \
        [u * bv[i % 2] % (1 << 96) for i, u in enumerate(av)]
    quo = lb.mag_divexact_odd(a, b[:1], 4)
    assert quo.shape == (3, 2, 4)
    assert lb.limbs_to_ints(quo.reshape(6, 4)) == \
        [u * pow(bv[0], -1, 1 << 64) % (1 << 64) for u in av]
    for call in (lambda: cuda_group.mag_mul_cuda(a.to("meta"), b.to("meta"), 6),
                 lambda: cuda_group.mag_divexact_odd_cuda(a.to("meta"), b[:1].to("meta"), 4)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
