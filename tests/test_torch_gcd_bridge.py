"""compose2's selects around its two gcds: K6b's first-gcd operands
(cofhe_tpu_torch/csrc/compose_prologue.cu), K6c gcd_bridge
(csrc/gcd_bridge.cu) and K6d gcd2_merge (csrc/gcd2_merge.cu), through
their plain versions (compose2_plain.first_gcd_operands,
gcd_bridge_plain, gcd2_merge_plain, which the cuda_group dispatchers run
on CPU tensors) and Python models of the kernels' own steps, since they
run only on a card.

Each plain version is held to the JAX package's code it replaces
(cofhe_tpu/ops/forms2.py:522-537, 544-549, 570-572 and 588-589: limb.mag_bitlen,
limb.resize and jnp.where in its own order, jitted once a width) on rows
made from seeded numpy generators at the toy fixtures' widths (L = 24
and 64), with the edge rows: a's of exactly nb and nb + 1 bits (nb = 16
Lxn - 32), d1 = 2^120 - 1 and 2^120, identity lanes, and the narrow pass
absent (Lxn >= L, K6b and K6c write no narrow rows). The models (K6b and
K6c: thread t holds limbs [t NPT, t NPT + NPT), one ballot; K6d: thread t
the limbs t, t + 32, ...) are held to the plain versions at every NPT
1-9. On a card (`cuda` marker) each kernel is held to its plain version
at compose2's widths on 128 and 16384 rows. Tolerance: exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofhe_tpu.ops import limb as jlb
from cofhe_tpu_torch.ops import cuda_group
from cofhe_tpu_torch.ops import limb as lb
from cofhe_tpu_torch.ops.forms import BForm
from cofhe_tpu_torch.ops.compose2_plain import (compose2_prologue_plain, first_gcd_operands,
                                               gcd2_merge_plain, gcd_bridge_plain)

torch.set_num_threads(1)

# (L, Lxn, Lh): the toy fixtures' compose2 widths (100-bit p: no narrow
# pass; 731-bit p) and sec=128's
TOY = [(24, 24, 16), (64, 48, 32)]
CARD = TOY + [(144, 88, 72)]


def _rand(gen, bits):
    """A random integer of exactly `bits` bits (0 for 0)."""
    if bits <= 0:
        return 0
    return int.from_bytes(gen.bytes((bits + 7) // 8), "little") % (1 << (bits - 1)) \
        | (1 << (bits - 1))


def _limbs(vals, L):
    return torch.from_numpy(lb.ints_to_limbs(vals, L))


def _cols(*ts):
    return [t.tolist() for t in ts]


def _eq(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(torch.as_tensor(g), torch.as_tensor(np.array(w))), (g, w)


# ------------------------------------------------ the JAX package's code


def _jax_first(a1, a2, NL):
    """cofhe_tpu/ops/forms2.py:522-533."""
    nb = 16 * NL - 32
    fitsx = (jlb.mag_bitlen(a2) <= nb) & (jlb.mag_bitlen(a1) <= nb)
    fx = fitsx[..., None]
    one_n = jnp.concatenate([jnp.ones_like(a2[..., :1]),
                             jnp.zeros_like(a2[..., 1:NL])], axis=-1)
    a2_n = jnp.where(fx, a2[..., :NL], one_n)
    a1_n = jnp.where(fx, a1[..., :NL], 0)
    one_L = jnp.concatenate([jnp.ones_like(a2[..., :1]),
                             jnp.zeros_like(a2[..., 1:])], axis=-1)
    a2_w = jnp.where(fx, one_L, a2)
    a1_w = jnp.where(fx, 0, a1)
    return fitsx, a2_n, a1_n, a2_w, a1_w


def _jax_bridge(d1_w, beta_w, some_id, d1_n, beta_n, fitsx, Lh, narrow):
    """cofhe_tpu/ops/forms2.py:536-537, 544-547, 549 and 570-572 (d1_8L:
    the REDC's d1_8 at Lh)."""
    L = d1_w.shape[-1]
    if narrow:
        fx = fitsx[..., None]
        d1 = jnp.where(fx, jlb.resize(d1_n, L), d1_w)
        beta = jnp.where(fx, jlb.resize(beta_n, L), beta_w)
    else:
        d1, beta = d1_w, beta_w
    fits8 = jlb.mag_bitlen(d1) <= 120
    one8 = jnp.concatenate([jnp.ones_like(d1[..., :1]),
                            jnp.zeros_like(d1[..., 1:8])], axis=-1)
    d1_8 = jnp.where(fits8[..., None], d1[..., :8], one8)
    d1_8L = jlb.resize(d1_8, Lh)
    rare = jnp.logical_not(fits8) & jnp.logical_not(some_id)
    d1h = jlb.resize(d1, Lh)
    d1h = jnp.where(rare[..., None], d1h, jlb.resize(one8, Lh))
    return d1, beta, fits8, rare, d1_8, d1_8L, d1h


def _jax_merge(g8, eta0_8, gF, eta0F, fits8):
    """cofhe_tpu/ops/forms2.py:588-589."""
    Lh = gF.shape[-1]
    g = jnp.where(fits8[..., None], jlb.resize(g8, Lh), jlb.resize(gF, Lh))
    eta0 = jnp.where(fits8[..., None], jlb.resize(eta0_8, Lh), eta0F)
    return g, eta0


_JAX_FIRST = jax.jit(_jax_first, static_argnums=2)
_JAX_BRIDGE = jax.jit(_jax_bridge, static_argnums=(6, 7))
_JAX_MERGE = jax.jit(_jax_merge)


# ---------------------------------------------------------------- operands


def _a_rows(gen, L, Lxn, B):
    """a1, a2 (canonical (B, L)): every pair of bit lengths from {0, 1,
    nb - 1, nb, nb + 1, 16 L - 1} first, then random ones around nb."""
    nb = 16 * Lxn - 32
    edge = [b for b in (0, 1, nb - 1, nb, nb + 1, 16 * L - 1) if 0 <= b <= 16 * L]
    pairs = [(x, y) for x in edge for y in edge]
    pairs += [tuple(int(gen.integers(max(0, nb - 40), min(16 * L, nb + 40) + 1))
                    for _ in range(2)) for _ in range(max(0, B - len(pairs)))]
    a1 = [_rand(gen, x) for x, _ in pairs]
    a2 = [_rand(gen, y) for _, y in pairs]
    return _limbs(a1, L), _limbs(a2, L)


def _d1_vals(gen, W, n):
    """n values below 2^(16 W): 2^120 - 1, 2^120, 2^119, 2^121, 1 and the
    largest first, then random bit lengths of up to 16 W."""
    top = 16 * W
    edge = [v for v in ((1 << 120) - 1, 1 << 120, 1 << 119, 1 << 121, 1, 3,
                        (1 << top) - 1) if v < 1 << top]
    return (edge + [_rand(gen, int(gen.integers(1, top + 1)))
                    for _ in range(n)])[:n]


def _bridge_args(gen, L, Lxn, Lh, B, narrow):
    """(d1_w, beta_w, id1, id2, Lh, narrow): random rows and masks; the
    merged d1 meets the edge values on narrow and wide lanes."""
    d1_w = _limbs(_d1_vals(gen, L, B), L)
    beta_w = _limbs([_rand(gen, int(gen.integers(0, 16 * L + 1))) for _ in range(B)], L)
    id1 = torch.from_numpy(gen.random(B) < 0.2)
    id2 = torch.from_numpy(gen.random(B) < 0.2)
    if not narrow:
        return d1_w, beta_w, id1, id2, Lh, None
    d1_n = _limbs(_d1_vals(gen, Lxn, B), Lxn)
    beta_n = _limbs([_rand(gen, int(gen.integers(0, 16 * Lxn + 1))) for _ in range(B)], Lxn)
    fx = torch.from_numpy(gen.random(B) < 0.5)
    return d1_w, beta_w, id1, id2, Lh, (d1_n, beta_n, fx)


def _merge_args(gen, Lh, B):
    g8 = _limbs([_rand(gen, int(gen.integers(0, 129))) for _ in range(B)], 8)
    e8 = _limbs([_rand(gen, int(gen.integers(0, 129))) for _ in range(B)], 8)
    gF = _limbs([_rand(gen, int(gen.integers(0, 16 * Lh + 1))) for _ in range(B)], Lh)
    eF = _limbs([_rand(gen, int(gen.integers(0, 16 * Lh + 1))) for _ in range(B)], Lh)
    return g8, e8, gF, eF, torch.from_numpy(gen.random(B) < 0.5)


def _j(t):
    return jnp.asarray(t.numpy())


# ------------------------------------------------------ against the JAX code


@pytest.mark.parametrize("L,Lxn,Lh", TOY + [(24, 16, 16)])
def test_first_gcd_operands_match_jax(L, Lxn, Lh):
    gen = np.random.default_rng(L + Lxn)
    a1, a2 = _a_rows(gen, L, Lxn, 48)
    got = first_gcd_operands(a1, a2, Lxn)
    _eq(got, _JAX_FIRST(_j(a1), _j(a2), Lxn))
    assert got[0].dtype == torch.bool and bool(got[0].any()) and not bool(got[0].all())


@pytest.mark.parametrize("L,Lxn,Lh", TOY)
def test_prologue_gives_the_first_gcd_operands_below_l(L, Lxn, Lh):
    """compose2_prologue_plain adds first_gcd_operands of its a1, a2 when
    Lxn < L and nothing when Lxn >= L (the 100-bit toy width)."""
    gen = np.random.default_rng(7 + L)
    B = 36
    a1, a2 = _a_rows(gen, L, max(Lxn, 3), B)

    def form(a, odd):
        a = a.clone()
        if odd:
            a[:, 0] |= 1
        b = _limbs([_rand(gen, 16 * Lh - 4) for _ in range(B)], L)
        c = _limbs([_rand(gen, 16 * L - 4) for _ in range(B)], L)
        sg = torch.from_numpy(gen.choice(np.array([-1, 1], dtype=np.int32), B))
        return BForm(a, sg, b, c)

    F1, F2 = form(a1, False), form(a2, True)
    h = BForm(*(x[:1] for x in form(a1, True)))
    out = compose2_prologue_plain(F1, F2, h, h, Lh, Lxn)
    base = compose2_prologue_plain(F1, F2, h, h, Lh)
    _eq(out[:14], base)
    if Lxn >= L:
        assert len(out) == 14
        return
    assert len(out) == 19
    _eq(out[14:], first_gcd_operands(out[0], out[4], Lxn))
    assert bool(out[14].any()) and not bool(out[14].all())


@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("L,Lxn,Lh", TOY)
def test_gcd_bridge_matches_jax(L, Lxn, Lh, narrow):
    gen = np.random.default_rng(11 + L + narrow)
    if narrow and Lxn >= L:
        Lxn = L - 8
    args = _bridge_args(gen, L, Lxn, Lh, 64, narrow)
    got = gcd_bridge_plain(*args)
    d1_w, beta_w, id1, id2, _, nar = args
    nar = nar or (d1_w[:, :Lxn], beta_w[:, :Lxn], id1)
    want = _JAX_BRIDGE(_j(d1_w), _j(beta_w), _j(id1 | id2), *map(_j, nar), Lh, narrow)
    _eq(got, want)
    fits8, rare = got[2], got[3]
    # both sides of 2^120 and rare lanes are live
    assert bool(fits8.any()) and not bool(fits8.all()) and bool(rare.any())
    assert bool((~fits8 & (id1 | id2)).any())


@pytest.mark.parametrize("Lh", [16, 32, 72])
def test_gcd2_merge_matches_jax(Lh):
    gen = np.random.default_rng(Lh)
    args = _merge_args(gen, Lh, 40)
    _eq(gcd2_merge_plain(*args), _JAX_MERGE(*map(_j, args)))


# ----------------------------------------------------- the kernels' models


def _first_model(a1, a2, L, Lxn):
    """K6b's first_gcd_operands on one row: each thread its NPT limbs, a
    flag where it holds a nonzero limb from Lxn - 2 on, one ballot."""
    npt = (L + 31) // 32
    x1 = a1 + [0] * (32 * npt - L)
    x2 = a2 + [0] * (32 * npt - L)
    wide = [any(t * npt + j >= Lxn - 2 and (x1[t * npt + j] | x2[t * npt + j]) != 0
                for j in range(npt)) for t in range(32)]
    fx = not any(wide)
    a2n, a1n, a2w, a1w = [0] * Lxn, [0] * Lxn, [0] * L, [0] * L
    for t in range(32):
        for j in range(npt):
            i = t * npt + j
            one = int(i == 0)
            if i < Lxn:
                a2n[i], a1n[i] = (x2[i], x1[i]) if fx else (one, 0)
            if i < L:
                a2w[i], a1w[i] = (one, 0) if fx else (x2[i], x1[i])
    return fx, a2n, a1n, a2w, a1w


def _bridge_model(d1_w, beta_w, id1, id2, d1_n, beta_n, fx, L, Lxn, Lh):
    """K6c on one row (Lxn = 0: no narrow pass): d1 loaded from the pass fx
    picks (wl::load_row, zero-extended), beta from the same, a flag a
    thread, one ballot, the stores."""
    npt = (L + 31) // 32
    nar = Lxn > 0 and fx
    src, n = (d1_n, Lxn) if nar else (d1_w, L)
    x = [src[i] if i < n else 0 for i in range(32 * npt)]
    bsrc, bn = (beta_n, Lxn) if nar else (beta_w, L)
    beta = [bsrc[i] if i < bn else 0 for i in range(L)]
    big = [any((t * npt + j >= 8 and x[t * npt + j] != 0)
               or (t * npt + j == 7 and x[t * npt + j] >= 256) for j in range(npt))
           for t in range(32)]
    fits8 = not any(big)
    rare = not fits8 and not (id1 or id2)
    d1_8, d1_8h, d1h = [0] * 8, [0] * Lh, [0] * Lh
    for i in range(32 * npt):
        one = int(i == 0)
        v8 = (x[i] if i < 8 else 0) if fits8 else one
        if i < 8:
            d1_8[i] = v8
        if i < Lh:
            d1_8h[i] = v8
            d1h[i] = x[i] if rare else one
    return x[:L], beta, fits8, rare, d1_8, d1_8h, d1h


def _merge_model(g8, e8, gF, eF, fits8, Lh):
    """K6d on one row: thread t writes limbs t, t + 32, ... from the one
    pipeline fits8 picks."""
    g, e = [0] * Lh, [0] * Lh
    for t in range(32):
        for i in range(t, Lh, 32):
            if fits8:
                g[i], e[i] = (g8[i], e8[i]) if i < len(g8) else (0, 0)
            else:
                g[i], e[i] = gF[i], eF[i]
    return g, e


@pytest.mark.parametrize("npt", range(1, 10))
def test_kernel_models_match_the_plain_versions(npt):
    L = 32 * npt - (npt % 3)  # a full row, and ones that leave limbs spare
    Lh, Lxn = max(8, L // 2), max(9, (3 * L) // 4)
    gen = np.random.default_rng(70 + npt)
    # K6b's first-gcd operands
    a1, a2 = _a_rows(gen, L, Lxn, 40)
    fx, a2n, a1n, a2w, a1w = first_gcd_operands(a1, a2, Lxn)
    for r, (x, y) in enumerate(zip(a1.tolist(), a2.tolist())):
        assert _first_model(x, y, L, Lxn) == (bool(fx[r]), *_cols(a2n[r], a1n[r], a2w[r],
                                                                  a1w[r])), r
    # K6c with and without the narrow pass
    for narrow in (True, False):
        args = _bridge_args(gen, L, Lxn, Lh, 40, narrow)
        got = gcd_bridge_plain(*args)
        d1_w, beta_w, id1, id2, _, nar = args
        for r in range(40):
            rows = (nar[0][r].tolist(), nar[1][r].tolist(), bool(nar[2][r])) if narrow \
                else (None, None, False)
            want = _bridge_model(d1_w[r].tolist(), beta_w[r].tolist(), bool(id1[r]),
                                 bool(id2[r]), *rows, L, Lxn if narrow else 0, Lh)
            assert want == (*_cols(got[0][r], got[1][r]), bool(got[2][r]), bool(got[3][r]),
                            *_cols(got[4][r], got[5][r], got[6][r])), (narrow, r)
    # K6d
    args = _merge_args(gen, Lh, 40)
    g, e = gcd2_merge_plain(*args)
    for r in range(40):
        assert _merge_model(*(x[r].tolist() for x in args[:4]), bool(args[4][r]), Lh) \
            == (g[r].tolist(), e[r].tolist()), r


# ------------------------------------------------------------- dispatchers


def test_dispatchers_route_by_device():
    """A CPU tensor takes the plain version and counts no launch; the
    kernels' wrappers refuse one (no fallback either way)."""
    gen = np.random.default_rng(5)
    before = dict(cuda_group.LAUNCHES)
    for narrow in (True, False):
        args = _bridge_args(gen, 64, 48, 32, 16, narrow)
        _eq(cuda_group.gcd_bridge(*args), gcd_bridge_plain(*args))
        with pytest.raises(ValueError, match="CUDA"):
            cuda_group.gcd_bridge_cuda(*args)
    args = _merge_args(gen, 32, 16)
    _eq(cuda_group.gcd2_merge(*args), gcd2_merge_plain(*args))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_group.gcd2_merge_cuda(*args)
    assert cuda_group.LAUNCHES == before


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6b, K6c and K6d are Hopper kernels")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_the_plain_versions_on_card(cuda_device):
    def dev(x):
        if isinstance(x, tuple):
            return type(x)(*(dev(y) for y in x)) if hasattr(x, "_fields") \
                else tuple(dev(y) for y in x)
        return x.to(cuda_device) if isinstance(x, torch.Tensor) else x

    for L, Lxn, Lh in CARD:
        for B in (128, 16384):
            gen = np.random.default_rng(L + B)
            for narrow in (True, False):
                args = dev(_bridge_args(gen, L, min(Lxn, L - 8), Lh, B, narrow))
                want = cuda_group.gcd_bridge_plain(*args)
                got = cuda_group.gcd_bridge_cuda(*args)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (L, B, narrow)
            args = dev(_merge_args(gen, Lh, B))
            got = cuda_group.gcd2_merge_cuda(*args)
            assert all(torch.equal(g, w) for g, w in
                       zip(got, cuda_group.gcd2_merge_plain(*args))), (L, B)
            a1, a2 = dev(_a_rows(gen, L, Lxn, B))
            sg = torch.ones(B, dtype=torch.int32, device=cuda_device)
            F1, F2 = BForm(a1, sg, a1, a2), BForm(a2, -sg, a2, a1)
            h = BForm(a2[:1], sg[:1], a1[:1], a2[:1])
            for lx in (Lxn, None):
                got = cuda_group.compose_prologue_cuda(F1, F2, h, h, Lh, lx)
                want = cuda_group.compose_prologue_plain(F1, F2, h, h, Lh, lx)
                assert len(got) == len(want)
                assert all(torch.equal(g, w) for g, w in zip(got, want)), (L, B, lx)
