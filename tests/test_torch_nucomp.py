"""The port's NUCOMP composition tail (cofhe_tpu_torch.ops.rl.lehmer_euclid,
forms2.CG with use_nucomp) against the JAX package's (rl.lehmer_euclid, CG
built under COFHE_NUCOMP=1), the pure-Python oracle and the port's default
compose2.

lehmer_euclid's redundant outputs are compared by value, and also limb by
limb, and `par` exactly, at 16, 24 (the toy fixture's width), 32 and 40
limbs (the port's estimates sum in XLA's CPU order, which differs below,
inside and above 17-32 terms), on lanes that include quotient gaps past 20 bits
(r1 far below r0, and r0 = q*r1 + small with q > 2^13) so that the
shifted-digit step runs; the invariants r = x*r0 + y*r1 and
det [[xp, yp], [xc, yc]] = (-1)^par hold on every lane. compose2 and
nudupl2 run on tests/test_torch_forms2.py's operand classes (identities,
self-composes, inverse pairs, powers of f) with the toy fixtures.
Tolerance: exact equality of every output (reduced forms are unique).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofhe_tpu.core.qfi import compose
from cofhe_tpu.ops import rl as jrl
from cofhe_tpu.ops.forms import bform_from_forms as jbform_from_forms
from cofhe_tpu.ops.forms2 import CG as JCG
from cofhe_tpu_torch.ops import limb as lb
from cofhe_tpu_torch.ops import rl
from cofhe_tpu_torch.ops.forms import bform_from_forms, bform_to_forms
from cofhe_tpu_torch.ops.forms2 import CG
from test_torch_forms2 import _cgs, _jax_out, _operands_compose, _tuples

torch.set_num_threads(1)

_jle = jax.jit(jrl.lehmer_euclid, static_argnames=("max_groups",))


def _value(x):
    s, m = lb.canonicalize_fast(torch.as_tensor(np.array(x)))
    return lb.limbs_to_ints(m, s)


@pytest.mark.parametrize("L,bits", [(16, 220), (24, 330), (32, 440), (40, 600)])
def test_lehmer_euclid_matches_jax(L, bits):
    rng = random.Random(L)
    B = 48
    r0 = [rng.getrandbits(rng.randrange(bits // 2, bits)) | 1 for _ in range(B)]
    r1 = [rng.randrange(1, x) for x in r0]
    for i in range(8):  # r1 far below r0
        r1[i] = rng.getrandbits(rng.randrange(24, bits // 3)) + 1
    for i in range(8, 16):  # r0 = q*r1 + small with q > 2^13
        r1[i] = rng.getrandbits(bits // 2) + 1
        q = rng.getrandbits(rng.randrange(14, bits // 4)) | (1 << 14)
        r0[i] = q * r1[i] + rng.randrange(r1[i])
    r1[16] = r0[16]
    r1[17] = 1
    m0, m1 = lb.ints_to_limbs(r0, L), lb.ints_to_limbs(r1, L)
    stop = np.array([rng.choice((20.0, bits / 4, bits / 3 + 0.5)) for _ in range(B)],
                    dtype=np.float32)
    stop[:16] = 10.0  # the big-gap lanes start working
    active = np.ones(B, bool)
    active[18] = False
    iters = torch.zeros(B, dtype=torch.int32)
    got = rl.lehmer_euclid(torch.from_numpy(m0), torch.from_numpy(m1),
                           torch.from_numpy(stop), bits // 8 + 24,
                           active=torch.from_numpy(active), iters=iters)
    want = _jle(jnp.asarray(m0), jnp.asarray(m1), jnp.asarray(stop),
                max_groups=bits // 8 + 24, active=jnp.asarray(active))
    for p, j in zip(got[:6], want[:6]):
        assert _value(p) == _value(j)
        assert np.array_equal(p.numpy(), np.asarray(j))
    assert np.array_equal(got[6].numpy(), np.asarray(want[6]))
    rp, rc, xp, xc, yp, yc = (_value(x) for x in got[:6])
    par = got[6].tolist()
    for i in range(B):
        assert rp[i] == xp[i] * r0[i] + yp[i] * r1[i], i
        assert rc[i] == xc[i] * r0[i] + yc[i] * r1[i], i
        assert xp[i] * yc[i] - yp[i] * xc[i] == (-1) ** par[i], i
    assert iters[18] == 0 and int(iters[:16].min()) > 0
    # the gap lanes took the shifted-digit step: in one group it removes
    # more bits than a matrix with entries below 2^13 can (not on every
    # lane: the JAX digit's exponent clamp can leave it far below 2^24)
    one = rl.lehmer_euclid(torch.from_numpy(m0[:16]), torch.from_numpy(m1[:16]),
                           torch.from_numpy(stop[:16]), 1)
    drops = [x.bit_length() - abs(v).bit_length() for v, x in zip(_value(one[0]), r0)]
    assert sum(d > 14 for d in drops) >= 4, drops


def test_compose2_unreduced_matches_jax(toy_hsm):
    """The nine outputs (a3, b3s, b3m, c3, a1g, m2x2, mu, id1, id2)."""
    jcg, pcg, L = _cgs(toy_hsm)
    f1, f2 = _operands_compose(toy_hsm, B=32)
    want = jax.jit(jcg.compose2_unreduced)(jbform_from_forms(f1, L),
                                           jbform_from_forms(f2, L))
    got = pcg.compose2_unreduced(bform_from_forms(f1, L, "cpu"),
                                 bform_from_forms(f2, L, "cpu"))
    assert len(got) == len(want) == 9
    for k, (p, j) in enumerate(zip(got, want)):
        assert np.array_equal(p.numpy(), np.asarray(j)), k


def test_nucomp_switch(toy_hsm, monkeypatch):
    jcg, pcg, L = _cgs(toy_hsm)
    args = (pcg.disc_bits, pcg.delta4, pcg.h, pcg.h2)
    assert not CG(*args).use_nucomp
    monkeypatch.setenv("COFHE_NUCOMP", "1")
    assert CG(*args).use_nucomp and not CG(*args, use_nucomp=False).use_nucomp
    assert (pcg.Ln, pcg.eu_groups) == (jcg.Ln, jcg.eu_groups)


def test_nucomp_compose2_nudupl2_match_jax(toy_hsm, monkeypatch):
    monkeypatch.setenv("COFHE_NUCOMP", "1")
    jcg, _, L = _cgs(toy_hsm)
    assert jcg.use_nucomp
    monkeypatch.delenv("COFHE_NUCOMP")
    ncg = CG.from_arrays(jcg.disc_bits, jcg.delta4,
                         (jcg.h_a, jcg.h_bs, jcg.h_b, jcg.h_c),
                         (jcg.h2_a, jcg.h2_bs, jcg.h2_b, jcg.h2_c), "cpu",
                         use_nucomp=True)
    dcg = CG.from_arrays(jcg.disc_bits, jcg.delta4,
                         (jcg.h_a, jcg.h_bs, jcg.h_b, jcg.h_c),
                         (jcg.h2_a, jcg.h2_bs, jcg.h2_b, jcg.h2_c), "cpu")
    f1, f2 = _operands_compose(toy_hsm)
    jcompose = jax.jit(jcg.compose2)
    want = _jax_out(jcompose, jbform_from_forms(f1, L), jbform_from_forms(f2, L))
    assert want == _tuples(compose(a, b) for a, b in zip(f1, f2))
    jd = jbform_from_forms(f2, L)
    want_sq = _jax_out(jcompose, jd, jd)
    assert want_sq == _tuples(compose(b, b) for b in f2)
    p1, p2 = bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu")
    for grouped in (True, False):
        assert _tuples(bform_to_forms(ncg.compose2(p1, p2, grouped=grouped))) == want
        assert _tuples(bform_to_forms(ncg.nudupl2(p2, grouped=grouped))) == want_sq
    assert _tuples(bform_to_forms(dcg.compose2(p1, p2))) == want
