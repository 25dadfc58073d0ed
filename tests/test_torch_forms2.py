"""The port's compose2 / nudupl2 / reduce2 (cofhe_tpu_torch.ops.forms2.CG,
on the CPU with the kernels' plain versions) against the JAX package's CG.

The port's CG is built from the very numpy arrays the JAX CG holds
(CG.from_arrays), and the operand classes are those of
tests/test_forms2.py:106-217: identities, self-composes, inverse pairs
(giant "freak" quotients), powers of f, and the two-tier first xgcd at a
731-bit p. Both reduction modes (grouped rho and per-quotient) run.
Tolerance: exact equality of the reduced forms, which are unique.
"""

import random

import jax
import numpy as np
import pytest
import torch

from cofhe_tpu.core.qfi import compose, identity_form, neg, nupow, reduce_form
from cofhe_tpu.ops import limb as jlb
from cofhe_tpu.ops.forms import bform_from_forms as jbform_from_forms
from cofhe_tpu.ops.forms import bform_to_forms as jbform_to_forms
from cofhe_tpu.ops.forms2 import CG as JCG
from cofhe_tpu.ops.forms2 import CGCtx as JCGCtx
from cofhe_tpu_torch.ops.forms import bform_from_forms, bform_to_forms
from cofhe_tpu_torch.ops.forms2 import CG, CGCtx

torch.set_num_threads(1)


def _cgs(hsm):
    """The JAX CG as tests/test_forms2.py builds it, and the port's CG from
    its arrays."""
    disc_bits = (-hsm.Delta).bit_length()
    L, _ = JCGCtx.widths_for_disc_bits(disc_bits)
    assert CGCtx.widths_for_disc_bits(disc_bits) == JCGCtx.widths_for_disc_bits(disc_bits)
    delta4 = jlb.ints_to_limbs([(-hsm.Delta) // 4], 2 * L)[0]
    h_bf = jbform_from_forms([hsm.h], L)
    jcg = JCG(disc_bits, delta4, (h_bf.a[0], h_bf.b_sign[0], h_bf.b[0], h_bf.c[0]))
    pcg = CG.from_arrays(disc_bits, jcg.delta4,
                         (jcg.h_a, jcg.h_bs, jcg.h_b, jcg.h_c),
                         (jcg.h2_a, jcg.h2_bs, jcg.h2_b, jcg.h2_c), "cpu")
    for name in ("L", "Lh", "Lxn", "Lu", "Lm", "Lsq", "mu_iters", "red_iters",
                 "xgcd_nbits", "dD_top", "dD_mant"):
        assert getattr(pcg, name) == getattr(jcg, name), name
    return jcg, pcg, L


def _tuples(forms):
    return [(f.a, f.b, f.c) for f in forms]


def _jax_out(fn, *bfs):
    out = jax.tree.map(np.asarray, fn(*bfs))
    return _tuples(jbform_to_forms(type(out)(*out)))


def _operands_compose(hsm, B=64):
    """tests/test_forms2.py:106-126."""
    rng = random.Random(3)
    ident = identity_form(hsm.Delta)
    pool = [nupow(hsm.h, rng.randrange(1, 1 << 60)) for _ in range(24)]
    f1 = [pool[rng.randrange(len(pool))] for _ in range(B)]
    f2 = [pool[rng.randrange(len(pool))] for _ in range(B)]
    f1[0] = ident
    f2[1] = ident
    f1[2] = ident
    f2[2] = ident
    f1[3] = f2[3]
    f1[4] = reduce_form(neg(f2[4]))
    f1[5] = hsm.f
    f2[6] = hsm.f
    f1[7] = hsm.power_of_f(5)
    f2[7] = hsm.power_of_f(9)
    return f1, f2


def test_compose2_and_nudupl2_match_jax(toy_hsm):
    jcg, pcg, L = _cgs(toy_hsm)
    f1, f2 = _operands_compose(toy_hsm)
    want = _jax_out(jax.jit(jcg.compose2), jbform_from_forms(f1, L),
                    jbform_from_forms(f2, L))
    assert want == _tuples(compose(a, b) for a, b in zip(f1, f2))
    p1, p2 = bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu")
    for grouped in (True, False):
        assert _tuples(bform_to_forms(pcg.compose2(p1, p2, grouped=grouped))) == want
    # nudupl2 = compose2(F, F), against the JAX compose2 of each lane with itself
    jd = jbform_from_forms(f2, L)
    want_sq = _jax_out(jax.jit(jcg.compose2), jd, jd)
    for grouped in (True, False):
        assert _tuples(bform_to_forms(pcg.nudupl2(p2, grouped=grouped))) == want_sq


def test_reduce2_modes_match_jax(toy_hsm):
    """tests/test_forms2.py:188-217: both reduction modes, adversarial
    operands (inverse pairs drop to the exact tail)."""
    jcg, pcg, L = _cgs(toy_hsm)
    rng = random.Random(11)
    ident = identity_form(toy_hsm.Delta)
    pool = [nupow(toy_hsm.h, rng.randrange(1, 1 << 60)) for _ in range(16)]
    B = 32
    f1 = [pool[rng.randrange(len(pool))] for _ in range(B)]
    f2 = [pool[rng.randrange(len(pool))] for _ in range(B)]
    f1[0] = ident
    f2[1] = ident
    f1[2] = f2[2]
    f1[3] = reduce_form(neg(f2[3]))
    f1[4] = reduce_form(neg(f2[4]))
    f1[5] = toy_hsm.power_of_f(3)
    f2[5] = toy_hsm.power_of_f(7)
    j1, j2 = jbform_from_forms(f1, L), jbform_from_forms(f2, L)
    p1, p2 = bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu")
    want = _tuples(compose(a, b) for a, b in zip(f1, f2))
    for grouped in (True, False):
        fn = jax.jit(lambda x, y, g=grouped: jcg.compose2(x, y, grouped=g))
        assert _jax_out(fn, j1, j2) == want
        # reduce2 on its own, from the unreduced composition
        a3, b3s, b3m, c3, id1, id2 = pcg.compose2_unreduced(p1, p2)
        red = pcg.reduce2(a3, b3s[..., None] * b3m, c3, grouped=grouped)
        got = _tuples(bform_to_forms(red))
        live = [i for i in range(B) if not (bool(id1[i]) or bool(id2[i]))]
        assert [got[i] for i in live] == [want[i] for i in live], grouped


def test_compose2_two_tier_xgcd_matches_jax():
    """tests/test_forms2.py:135-162: at a 731-bit p the narrow first xgcd
    (Lxn < L) is live; power-of-f lanes take the full-width pass."""
    from conftest import toy_prime
    from cofhe_tpu.core.cl_hsm2k import CLHSM2k

    hsm = CLHSM2k(128, 32, p=toy_prime(731))
    jcg, pcg, L = _cgs(hsm)
    assert pcg.Lxn < pcg.L
    rng = random.Random(11)
    pool = [nupow(hsm.h, rng.randrange(1, 1 << 60)) for _ in range(8)]
    B = 12
    f1 = [pool[rng.randrange(len(pool))] for _ in range(B)]
    f2 = [pool[rng.randrange(len(pool))] for _ in range(B)]
    f1[0] = hsm.power_of_f(5)
    f2[1] = hsm.power_of_f(9)
    f1[2] = hsm.power_of_f(3)
    f2[2] = hsm.power_of_f(7)
    f1[3] = identity_form(hsm.Delta)
    f1[4] = f2[4]
    want = _jax_out(jax.jit(jcg.compose2), jbform_from_forms(f1, L),
                    jbform_from_forms(f2, L))
    got = pcg.compose2(bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu"))
    assert _tuples(bform_to_forms(got)) == want
