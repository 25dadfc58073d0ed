"""The port's v1 composition (cofhe_tpu_torch.ops.forms.compose_batch /
nudupl_batch, with FormSpec and the v1 xgcd) against the JAX package's
(cofhe_tpu.ops.forms) and the pure-Python oracle (core.qfi).

Operands: tests/test_torch_forms2.py's classes with the toy fixtures
(identities, self-composes, inverse pairs, powers of f), and a batch of
coprime pairs on which the second xgcd is skipped. Tolerance: exact
equality of the reduced forms, which are unique.
"""

import random
from math import gcd

import jax
import numpy as np
import torch

from cofhe_tpu.core.qfi import compose, nupow
from cofhe_tpu.ops import forms as jforms
from cofhe_tpu.ops import limb as jlb
from cofhe_tpu.ops.forms import bform_from_forms as jbform_from_forms
from cofhe_tpu_torch.ops import forms
from cofhe_tpu_torch.ops.forms import bform_from_forms, bform_to_forms
from cofhe_tpu_torch.ops.xgcd import xgcd_mod
from test_torch_forms2 import _jax_out, _operands_compose, _tuples

torch.set_num_threads(1)


def _spec(hsm):
    disc_bits = (-hsm.Delta).bit_length()
    spec = forms.FormSpec.for_disc_bits(disc_bits)
    assert vars(spec) == vars(jforms.FormSpec.for_disc_bits(disc_bits))
    delta4 = jlb.ints_to_limbs([(-hsm.Delta) // 4], 2 * spec.L)[0]
    return spec, delta4


def test_compose_batch_matches_jax(toy_hsm, monkeypatch):
    calls = []
    monkeypatch.setattr(forms, "xgcd_mod",
                        lambda *a: calls.append(1) or xgcd_mod(*a))
    spec, delta4 = _spec(toy_hsm)
    L = spec.L
    jcompose = jax.jit(lambda x, y: jforms.compose_batch(x, y, spec, delta4))
    d4 = torch.from_numpy(delta4)
    f1, f2 = _operands_compose(toy_hsm, B=32)
    rng = random.Random(5)
    pool = [nupow(toy_hsm.h, rng.randrange(1, 1 << 60)) for _ in range(64)]

    def d1(x, y):  # gcd(a2, a1) after ordering a1 <= a2 and rotating a2 odd
        x, y = (x, y) if x.a <= y.a else (y, x)
        return gcd(y.a if y.a & 1 else y.c, x.a)

    pairs = [(x, y) for x in pool for y in pool if d1(x, y) == 1]
    coprime = tuple(map(list, zip(*rng.sample(pairs, 32))))
    for a, b, n_xgcd in ((f1, f2, 2), (*coprime, 1)):
        calls.clear()
        want = _jax_out(jcompose, jbform_from_forms(a, L), jbform_from_forms(b, L))
        assert want == _tuples(compose(x, y) for x, y in zip(a, b))
        got = forms.compose_batch(bform_from_forms(a, L, "cpu"),
                                  bform_from_forms(b, L, "cpu"), spec, d4)
        assert _tuples(bform_to_forms(got)) == want
        assert len(calls) == n_xgcd  # the second xgcd is skipped iff all d1 == 1


def test_nudupl_batch_matches_jax(toy_hsm):
    spec, delta4 = _spec(toy_hsm)
    L = spec.L
    _, f2 = _operands_compose(toy_hsm, B=32)
    f2[0] = toy_hsm.power_of_f(3)
    want = _jax_out(jax.jit(lambda x: jforms.nudupl_batch(x, spec, delta4)),
                    jbform_from_forms(f2, L))
    assert want == _tuples(compose(x, x) for x in f2)
    got = forms.nudupl_batch(bform_from_forms(f2, L, "cpu"), spec,
                             torch.from_numpy(np.asarray(delta4)))
    assert _tuples(bform_to_forms(got)) == want
