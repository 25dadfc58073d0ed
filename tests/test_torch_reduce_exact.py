"""The exact tail of the form reduction: the port's dispatcher
cuda_group.reduce_exact (KT on a card, its plain version on the CPU)
against the JAX package's forms.reduce_batch under jax.jit, and (on a CUDA
card only) KT against its plain version.

Inputs: K3's plain outputs (compose2_plain.grouped_rho_loop_wide,
redundant limbs) on the compose operands of tests/test_torch_forms2.py
(identities, self-composes, an inverse pair, powers of f), and hand-made
unreduced positive definite forms: b = -a, a = c with b < 0, normal but
not reduced (a > c), already reduced, and reduced forms translated by
quotients as large as the width leaves room for (~110 bits at the toy
width). The kernel's quotients are its own, the reference's are f32
estimates; reduced forms are unique, so the tolerance is exact equality.
"""

import random

import jax
import numpy as np
import pytest
import torch

from cofhe_tpu.core.qfi import Form, nupow, reduce_form
from cofhe_tpu.ops import forms as jforms
from cofhe_tpu_torch.ops import cuda_group
from cofhe_tpu_torch.ops import limb as lb
from cofhe_tpu_torch.ops.forms import bform_from_forms, bform_to_forms
from test_torch_forms2 import _cgs, _operands_compose

torch.set_num_threads(1)

HAND_B = 8  # lanes of each hand-made batch (one JAX compile for all kinds)
_JIT_REDUCE = jax.jit(jforms.reduce_batch, static_argnums=1)


def _jax_reduce(forms, L, max_iters):
    out = _JIT_REDUCE(jforms.bform_from_forms(forms, L), max_iters)
    out = jforms.BForm(*(np.asarray(x) for x in out))
    return [tuple(f) for f in jforms.bform_to_forms(out)]


def _redundant(forms, L):
    """(a, b, c) as the signed limb rows reduce_exact takes."""
    bf = bform_from_forms(forms, L, "cpu")
    return bf.a, bf.b_sign[:, None] * bf.b, bf.c


def _values(a, b, c):
    """Forms of the values of redundant limb rows."""
    av = lb.limbs_to_ints(lb.canonicalize_fast(a)[1])
    sb, bm = lb.canonicalize_fast(b)
    bv = lb.limbs_to_ints(bm, sb)
    cv = lb.limbs_to_ints(lb.canonicalize_fast(c)[1])
    return [Form(x, y, z) for x, y, z in zip(av, bv, cv)]


def _tuples(bf):
    return [tuple(f) for f in bform_to_forms(bf)]


def _k3_outputs(hsm):
    """K3's plain outputs on the compose operands of test_torch_forms2."""
    _, pcg, L = _cgs(hsm)
    f1, f2 = _operands_compose(hsm)
    a3, b3s, b3m, c3, *_ = pcg.compose2_unreduced(bform_from_forms(f1, L, "cpu"),
                                                  bform_from_forms(f2, L, "cpu"))
    raw = cuda_group.reduce2_grouped_loop(a3, b3s[..., None] * b3m, c3, pcg.dD_mant,
                                          pcg.dD_top, pcg.red_iters)
    return pcg, L, raw


def test_reduce_exact_matches_jax_on_k3_outputs(toy_hsm):
    pcg, L, raw = _k3_outputs(toy_hsm)
    vals = _values(*raw)
    want = _jax_reduce(vals, L, pcg.tail_iters)
    assert want == [tuple(reduce_form(f)) for f in vals]
    got = cuda_group.reduce_exact(*raw, pcg.tail_iters)
    assert got.a.shape == raw[0].shape and got.b_sign.dtype == torch.int32
    assert _tuples(got) == want
    # the CG's exact tail is this dispatcher
    assert _tuples(pcg._tail(*raw)) == want


def _hand_made(kind, hsm, L, rng):
    """HAND_B positive definite forms of one unreduced (or reduced) kind;
    the last two kinds have the discriminant of `hsm`. Every value keeps
    64 bits of headroom in L limbs."""
    out = []
    for _ in range(HAND_B):
        a = rng.getrandbits(rng.randrange(20, 120)) | 1
        if kind == "b=-a":
            out.append(Form(a, -a, a + rng.getrandbits(60)))
        elif kind == "a=c, b<0":
            out.append(Form(a, -rng.randrange(1, a), a))
        elif kind == "normal, a>c":
            c = rng.randrange(a // 2 + 1, a)
            out.append(Form(a, rng.randrange(-c + 1, c), c))
        else:
            f = nupow(hsm.h, rng.getrandbits(80) | 1)
            if kind == "translated":
                # (a, b + 2at, c + bt + at^2): c grows to ~a t^2
                t_bits = (16 * L - 64 - f.a.bit_length()) // 2
                t = rng.getrandbits(rng.randrange(1, t_bits)) * rng.choice((1, -1))
                f = Form(f.a, f.b + 2 * f.a * t, f.c + f.b * t + f.a * t * t)
            out.append(f)
    return out


@pytest.mark.parametrize("kind", ["b=-a", "a=c, b<0", "normal, a>c", "reduced",
                                  "translated"])
def test_reduce_exact_matches_jax_on_hand_made_forms(toy_hsm, kind):
    _, pcg, L = _cgs(toy_hsm)
    forms = _hand_made(kind, toy_hsm, L, random.Random(kind))
    want = _jax_reduce(forms, L, pcg.tail_iters)
    assert want == [tuple(reduce_form(f)) for f in forms]
    assert _tuples(cuda_group.reduce_exact(*_redundant(forms, L), pcg.tail_iters)) == want


def test_reduce_exact_refuses_other_devices():
    a = torch.ones((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cuda_group.reduce_exact(a, a, a, 10)


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_reduce_exact_kernel_matches_plain_on_card(cuda_device, toy_hsm):
    """KT on K3's outputs and on every hand-made kind against its plain
    version on the same card tensors; no lane at its cap."""
    pcg, L, raw = _k3_outputs(toy_hsm)
    cases = [raw] + [_redundant(_hand_made(k, toy_hsm, L, random.Random(k)), L)
                     for k in ("b=-a", "a=c, b<0", "normal, a>c", "reduced",
                               "translated")]
    for a, b, c in cases:
        a, b, c = (x.to(cuda_device).contiguous() for x in (a, b, c))
        iters = torch.zeros(a.shape[0], dtype=torch.int32, device=cuda_device)
        got = cuda_group.reduce_exact_cuda(a, b, c, pcg.tail_iters, iters=iters)
        want = cuda_group.reduce_exact_plain(a, b, c, pcg.tail_iters)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
        assert int(iters.max()) <= pcg.tail_iters
