"""K6e (cofhe_tpu_torch/csrc/c3_operands.cu): c3's operands in compose2's
epilogue, csum >> min(e, 16 Lm - 1) and a3 >> e at Lm limbs with e =
v2(a3), through its plain version (compose2_plain.c3_operands_plain,
which cuda_group.c3_operands runs on CPU tensors) and a Python model of
the kernel's own steps, since it runs only on a card.

The plain version is held to the JAX package's code it replaces
(cofhe_tpu/ops/forms2.py:638-641: limb.mag_v2, limb.mag_shr_bits_dyn and
limb.resize, jitted once a width) on rows made from seeded numpy
generators at the toy fixtures' widths (L, Lm = 24, 32 and 64, 104) and
at widths where a3 is as wide as csum or wider, so that the clamp of e
binds: the edge rows e = 0, 15, 16, a multiple of 16, 16 Lm - 1 and a
zero a3 (e = 16 L), beside random a3 with trailing zeros of every size.
The model (the two rows staged lane by lane, e from a warp minimum over
each thread's lowest nonzero limb and that limb's trailing zeros, thread
t writing the limbs t, t + 32, ... from two staged limbs each) is held to
the plain version at widths that give each thread 1 to 9 limbs. On a
card (`cuda` marker) the kernel is held to the plain version at 128 and
16384 rows. Tolerance: exact equality.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofhe_tpu.ops import limb as jlb
from cofhe_tpu_torch.ops import cuda_group
from cofhe_tpu_torch.ops import limb as lb
from cofhe_tpu_torch.ops.compose2_plain import c3_operands_plain

torch.set_num_threads(1)

# (L, Lm): the toy fixtures' (100-bit and 731-bit p), a3 as wide as csum
# and wider (the clamp of e binds on a zero a3 and on e >= 16 Lm - 1)
TOY = [(24, 32), (64, 104), (24, 24), (40, 24)]


def _jax_c3(a3, csum):
    """cofhe_tpu/ops/forms2.py:638-641, a3_odd at Lm as :641 passes it."""
    Lm = csum.shape[-1]
    e = jlb.mag_v2(a3)
    a3_odd = jlb.mag_shr_bits_dyn(a3, e)
    csum_sh = jlb.mag_shr_bits_dyn(csum, jnp.minimum(e, jnp.int32(16 * Lm - 1)))
    return csum_sh, jlb.resize(a3_odd, Lm)


_JAX_C3 = jax.jit(_jax_c3)


def _rows(gen, L, Lm, B):
    """(a3, csum): a3 with e = 0, 15, 16, 32, 16 Lm - 1 (where a3 has the
    bits), 16 L - 1 and a zero a3 first, then random a3 shifted left by
    random amounts; csum random and full."""
    top = 16 * L
    es = [e for e in (0, 15, 16, 32, 16 * Lm - 1, top - 1) if e < top]
    a3 = [1 << e for e in es] + [0]
    a3 += [((int.from_bytes(gen.bytes(2 * L), "little") | 1) << int(gen.integers(0, top)))
           % (1 << top) for _ in range(B - len(a3))]
    csum = [int.from_bytes(gen.bytes(2 * Lm), "little") for _ in range(B)]
    csum[1] = (1 << (16 * Lm)) - 1
    return (torch.from_numpy(lb.ints_to_limbs(a3, L)),
            torch.from_numpy(lb.ints_to_limbs(csum, Lm)))


@pytest.mark.parametrize("L,Lm", TOY)
def test_c3_operands_match_jax(L, Lm):
    gen = np.random.default_rng(L * Lm)
    a3, csum = _rows(gen, L, Lm, 48)
    got = c3_operands_plain(a3, csum)
    want = _JAX_C3(jnp.asarray(a3.numpy()), jnp.asarray(csum.numpy()))
    for g, w in zip(got, want):
        assert torch.equal(g, torch.from_numpy(np.array(w)))
    # on Python integers: a zero a3 gives 0 and csum >> min(16 L, 16 Lm - 1)
    cs = lb.limbs_to_ints(csum)
    for r, v in enumerate(lb.limbs_to_ints(a3)):
        e = (v & -v).bit_length() - 1 if v else 16 * L
        assert lb.limbs_to_ints(got[0][r:r + 1]) == [cs[r] >> min(e, 16 * Lm - 1)], r
        assert lb.limbs_to_ints(got[1][r:r + 1]) == [(v >> e) % (1 << (16 * Lm))], r


def _model(a3, csum, L, Lm):
    """K6e on one row: both rows staged, e from the warp minimum of each
    thread's lowest nonzero limb (its limbs t, t + 32, ...) and __ffs of
    that limb, then each thread's output limbs from two staged limbs."""
    firsts = [next((i for i in range(t, L, 32) if a3[i] != 0), L) for t in range(32)]
    first = min(firsts)
    e = 16 * first + ((a3[first] & -a3[first]).bit_length() - 1) if first < L else 16 * L

    def shr(s, n, bits):
        q, r = bits >> 4, bits & 15
        out = [0] * Lm
        for t in range(32):
            for i in range(t, Lm, 32):
                k = i + q
                lo = s[k] if k < n else 0
                up = s[k + 1] if k + 1 < n else 0
                out[i] = (lo >> r) | ((up << (16 - r)) & 0xFFFF)
        return out

    return shr(csum, Lm, min(e, 16 * Lm - 1)), shr(a3, L, e)


@pytest.mark.parametrize("npt", range(1, 10))
def test_kernel_model_matches_the_plain_version(npt):
    gen = np.random.default_rng(90 + npt)
    L = 32 * npt - (npt % 3)
    Lm = min(288, L + 8 * (npt % 4))
    a3, csum = _rows(gen, L, Lm, 24)
    sh, odd = c3_operands_plain(a3, csum)
    for r in range(24):
        assert _model(a3[r].tolist(), csum[r].tolist(), L, Lm) == (sh[r].tolist(),
                                                                  odd[r].tolist()), r


def test_dispatcher_routes_by_device():
    """A CPU tensor takes the plain version and counts no launch; the
    kernel's wrapper refuses one (no fallback either way)."""
    a3, csum = _rows(np.random.default_rng(4), 64, 104, 16)
    before = dict(cuda_group.LAUNCHES)
    for g, w in zip(cuda_group.c3_operands(a3, csum), c3_operands_plain(a3, csum)):
        assert torch.equal(g, w)
    assert cuda_group.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA"):
        cuda_group.c3_operands_cuda(a3, csum)


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6e is a Hopper kernel")
    return torch.device("cuda")


@pytest.mark.cuda
def test_c3_operands_kernel_matches_the_plain_version_on_card(cuda_device):
    for L, Lm in TOY + [(144, 264), (288, 288), (1, 1)]:
        for B in (128, 16384):
            a3, csum = (x.to(cuda_device) for x in _rows(np.random.default_rng(L + B),
                                                         L, Lm, B))
            got = cuda_group.c3_operands_cuda(a3, csum)
            want = cuda_group.c3_operands_plain(a3, csum)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (L, Lm, B)
