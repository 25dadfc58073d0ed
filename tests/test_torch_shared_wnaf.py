"""The port's shared-exponent wNAF ladder
(cofhe_tpu_torch.ops.nupow2.nupow_shared_wnaf2) against the JAX package's
(cofhe_tpu.ops.nupow2.nupow_shared_wnaf2), the port's bank + segments as
the decrypt path runs them (here in two segments), and core.qfi.nupow.

Toy fixtures, 6 lanes (powers of h, h itself, f, an identity), a 32-bit
exponent, its wNAF digit stream front-padded with zeros as the JAX
callers pad it. Tolerance: exact equality of the reduced forms.
"""

import random

import jax
import jax.numpy as jnp
import torch

from cofhe_tpu.core.qfi import identity_form, nupow
from cofhe_tpu.ops.forms import bform_from_forms as jbform_from_forms
from cofhe_tpu.ops.nupow2 import nupow_shared_wnaf2 as jnupow_shared_wnaf2
from cofhe_tpu_torch.ops.forms import bform_from_forms, bform_to_forms
from cofhe_tpu_torch.ops.nupow2 import (identity_bform2, make_wnaf_bank,
                                        nupow_shared_wnaf2, wnaf_digits,
                                        wnaf_segment)
from test_torch_forms2 import _cgs, _jax_out, _tuples

torch.set_num_threads(1)


def test_nupow_shared_wnaf2_matches_jax(toy_hsm):
    jcg, pcg, L = _cgs(toy_hsm)
    rng = random.Random(205)
    e = rng.getrandbits(32) | (1 << 31)
    base = [nupow(toy_hsm.h, rng.randrange(1, 1 << 40)) for _ in range(3)]
    base += [toy_hsm.h, toy_hsm.f, identity_form(toy_hsm.Delta)]
    digits = wnaf_digits(e, 5)
    sched = [0] * (40 - len(digits)) + digits
    want = _jax_out(jax.jit(lambda b, s: jnupow_shared_wnaf2(jcg, b, s, 5)),
                    jbform_from_forms(base, L), jnp.asarray(sched, jnp.int32))
    assert want == _tuples(nupow(f, e) for f in base)
    pb = bform_from_forms(base, L, "cpu")
    assert _tuples(bform_to_forms(nupow_shared_wnaf2(pcg, pb, sched))) == want
    bank = make_wnaf_bank(pcg, pb, 5)
    r = wnaf_segment(pcg, bank, identity_bform2(pcg, len(base)), digits[:20])
    r = wnaf_segment(pcg, bank, r, digits[20:])
    assert _tuples(bform_to_forms(r)) == want
