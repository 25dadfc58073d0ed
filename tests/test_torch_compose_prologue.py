"""K6b (cofhe_tpu_torch/csrc/compose_prologue.cu): compose2's prologue,
through its plain version (compose2_plain.compose2_prologue_plain, which
CG.compose2_prologue dispatches on CPU tensors) and, on the CPU, the
whole compose2 around it.

The prologue, by its definitions on Python integers: the identity masks
(a == 1), h and h^2 in place of both operands where either is the
identity, the swap to a1 <= a2, F2 rotated to (c, -b, a) where its a is
even, s = (b1 + b2) / 2 (sign and |s| >> 1) and dd = b2 - b1 on the b's
cut to Lh limbs. The operands are those of tests/test_forms2.py:106-217:
identities on either side and on both, self-composes and inverse pairs
(equal a's), powers of f and the form f (even a), and random powers of h;
the test checks that each class is live (an identity lane, a swapped
lane, a rotated lane). The whole compose2 on these operands is held to
the JAX package's CG.compose2 (jitted) and to the Python oracle's
compose. On a card (`cuda` marker) the kernel is held to the plain
version at 128 and 16384 lanes. Tolerance: exact equality.
"""

import random

import jax
import pytest
import torch

from cofhe_tpu.core.qfi import compose, identity_form, neg, nupow, reduce_form
from cofhe_tpu.ops.forms import bform_from_forms as jbform_from_forms
from cofhe_tpu_torch.ops import cuda_group
from cofhe_tpu_torch.ops import limb as lb
from cofhe_tpu_torch.ops.forms import bform_from_forms, bform_to_forms
from cofhe_tpu_torch.ops.compose2_plain import compose2_prologue_plain
from test_torch_forms2 import _cgs, _jax_out, _tuples

torch.set_num_threads(1)


def _operands(hsm, B=32, seed=3):
    rng = random.Random(seed)
    ident = identity_form(hsm.Delta)
    pool = [nupow(hsm.h, rng.randrange(1, 1 << 60)) for _ in range(24)]
    f1 = [pool[rng.randrange(len(pool))] for _ in range(B)]
    f2 = [pool[rng.randrange(len(pool))] for _ in range(B)]
    f1[0] = ident
    f2[1] = ident
    f1[2] = f2[2] = ident
    f1[3] = f2[3]                        # self-compose: equal a's
    f1[4] = reduce_form(neg(f2[4]))      # inverse pair: equal a's
    f1[5] = hsm.f
    f2[6] = hsm.f
    f1[7] = hsm.power_of_f(5)
    f2[7] = hsm.power_of_f(9)
    f1[8] = hsm.power_of_f(3)
    f2[9] = hsm.power_of_f(7)
    return f1, f2


def _sgn(v: int) -> int:
    return (v > 0) - (v < 0)


def _canon(v: int, W: int):
    """(sign, mag) that limb.canonicalize_fast gives for a value v at width
    W: v itself inside |v| < 2^(16 W); past it, the remainder mod 2^(16 W)
    with the sign of the quotient (what its carries into the top limb
    leave)."""
    q, r = divmod(v, 1 << (16 * W))
    mag = r if q >= 0 else (-r) % (1 << (16 * W))
    return (0 if mag == 0 else (-1 if q < 0 else 1)), mag


def _oracle(f1, f2, h, h2, Lh):
    """The prologue of one lane on Python integers: (a1, b1, c1, a2, b2, c2,
    sign(s), |s| >> 1, sign(dd), |dd|, id1, id2) and whether it swapped and
    rotated. s and dd are canonical at Lh limbs (_canon)."""
    id1, id2 = f1[0] == 1, f2[0] == 1
    if id1 or id2:
        f1, f2 = h, h2
    swap = f1[0] > f2[0]
    if swap:
        f1, f2 = f2, f1
    a2, b2, c2 = f2
    rot = a2 % 2 == 0
    if rot:
        a2, b2, c2 = c2, -b2, a2
    mod = 1 << (16 * Lh)
    b1h, b2h = _sgn(f1[1]) * (abs(f1[1]) % mod), _sgn(b2) * (abs(b2) % mod)
    (ss, sm), dd = _canon(b1h + b2h, Lh), _canon(b2h - b1h, Lh)
    out = (*f1, a2, b2, c2, ss, sm >> 1, *dd, id1, id2)
    return out, swap, rot


def _form(F, i=None):
    """(a, b, c) of lane i of a BForm, or of a single-form BForm."""
    pick = (lambda t: t.reshape(1, -1)) if i is None else (lambda t: t[i:i + 1])
    a, c = lb.limbs_to_ints(pick(F.a))[0], lb.limbs_to_ints(pick(F.c))[0]
    sb = F.b_sign.reshape(-1)[0 if i is None else i]
    return a, lb.limbs_to_ints(pick(F.b), sb.reshape(1))[0], c


def _lanes(out, B):
    """The plain version's outputs as the oracle's tuples, lane by lane."""
    a1, b1s, b1m, c1, a2, b2s, b2m, c2, ss, sm, dds, ddm, id1, id2 = out
    cols = [lb.limbs_to_ints(a1), lb.limbs_to_ints(b1m, b1s), lb.limbs_to_ints(c1),
            lb.limbs_to_ints(a2), lb.limbs_to_ints(b2m, b2s), lb.limbs_to_ints(c2),
            ss.tolist(), lb.limbs_to_ints(sm), dds.tolist(), lb.limbs_to_ints(ddm),
            id1.tolist(), id2.tolist()]
    return [tuple(c[i] for c in cols) for i in range(B)]


def test_prologue_plain_matches_the_python_oracle(toy_hsm):
    _, pcg, L = _cgs(toy_hsm)
    f1, f2 = _operands(toy_hsm)
    p1, p2 = bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu")
    out = pcg.compose2_prologue(p1, p2)
    assert all(torch.equal(x, y) for x, y in zip(
        out, compose2_prologue_plain(p1, p2, pcg.h, pcg.h2, pcg.Lh)))
    h, h2 = _form(pcg.h), _form(pcg.h2)
    got = _lanes(out, len(f1))
    swaps = rots = 0
    for i, (x, y) in enumerate(zip(f1, f2)):
        want, swap, rot = _oracle((x.a, x.b, x.c), (y.a, y.b, y.c), h, h2, pcg.Lh)
        assert got[i] == want, i
        swaps += swap
        rots += rot
    # every class is live: identities, swapped lanes, rotated lanes
    assert got[0][-2] and got[1][-1] and got[2][-2] and got[2][-1]
    assert swaps and rots
    assert out[-2].dtype == torch.bool and out[-1].dtype == torch.bool


def test_prologue_cuts_b_to_lh_limbs(toy_hsm):
    """The b's enter s and dd cut to Lh limbs, as lb.resize cuts them (the
    torch code adds no check): rows whose b is wider than Lh."""
    _, pcg, L = _cgs(toy_hsm)
    rng = random.Random(5)
    Lh = pcg.Lh
    forms = []
    for _ in range(8):
        a = rng.randrange(1 << (16 * Lh), 1 << (16 * L - 2))
        forms.append(((a | 1), rng.randrange(-a, a), rng.randrange(a, 2 * a)))

    def bf(fs):
        return bform_from_forms([type("F", (), dict(a=x, b=y, c=z)) for x, y, z in fs],
                                L, "cpu")

    out = pcg.compose2_prologue(bf(forms), bf(forms[::-1]))
    got = _lanes(out, 8)
    h, h2 = _form(pcg.h), _form(pcg.h2)
    for i, (x, y) in enumerate(zip(forms, forms[::-1])):
        assert got[i] == _oracle(x, y, h, h2, Lh)[0], i


def test_compose2_around_the_prologue_matches_jax(toy_hsm):
    jcg, pcg, L = _cgs(toy_hsm)
    f1, f2 = _operands(toy_hsm, B=24, seed=8)
    want = _jax_out(jax.jit(jcg.compose2), jbform_from_forms(f1, L),
                    jbform_from_forms(f2, L))
    assert want == _tuples(compose(a, b) for a, b in zip(f1, f2))
    got = pcg.compose2(bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu"))
    assert _tuples(bform_to_forms(got)) == want


def test_dispatcher_routes_by_device(toy_hsm):
    _, pcg, L = _cgs(toy_hsm)
    f1, f2 = _operands(toy_hsm, B=16)
    p1, p2 = bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu")
    before = dict(cuda_group.LAUNCHES)
    got = cuda_group.compose_prologue(p1, p2, pcg.h, pcg.h2, pcg.Lh)
    want = cuda_group.compose_prologue_plain(p1, p2, pcg.h, pcg.h2, pcg.Lh)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert cuda_group.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_group.compose_prologue_cuda(p1, p2, pcg.h, pcg.h2, pcg.Lh)


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K6b is a Hopper kernel")
    return torch.device("cuda")


@pytest.mark.cuda
def test_prologue_kernel_matches_the_plain_version_on_card(cuda_device, toy_hsm):
    from conftest import toy_prime
    from cofhe_tpu_torch.core.cl_hsm2k import CLHSM2k
    from cofhe_tpu_torch.ops.engine import TorchEngine

    cg = TorchEngine(CLHSM2k(128, 32, p=toy_prime(100)), cuda_device).cg
    for B in (128, 16384):
        f1, f2 = _operands(toy_hsm, B=B, seed=B)
        p1, p2 = bform_from_forms(f1, cg.L, cuda_device), bform_from_forms(f2, cg.L,
                                                                           cuda_device)
        got = cuda_group.compose_prologue_cuda(p1, p2, cg.h, cg.h2, cg.Lh)
        want = compose2_prologue_plain(p1, p2, cg.h, cg.h2, cg.Lh)
        assert all(torch.equal(x, y) for x, y in zip(got, want)), B
