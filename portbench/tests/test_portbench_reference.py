"""The plain reference (portbench/reference.py) against the program's own
host arithmetic, at the toy parameters and at sec=128, k=128: the same
reduced forms, f^m and dlog, so exact comparison is sound."""

import random

import pytest

from cofhe_tpu_torch.core import qfi
from cofhe_tpu_torch.core.cl_hsm2k import CLHSM2k
from portbench import reference as ref

from toy import toy_prime


@pytest.fixture(scope="module", params=["toy", "sec128-k128"])
def pair(request):
    hsm = CLHSM2k(128, 32, p=toy_prime()) if request.param == "toy" else CLHSM2k(128, 128)
    return hsm, ref.CLGroup(hsm.p, hsm.k)


def test_parameters(pair):
    hsm, g = pair
    assert g.Delta == hsm.Delta and g.secretkey_bound == hsm.secretkey_bound()
    assert g.identity == tuple(hsm.identity)


def test_compose_power_and_inverse(pair):
    hsm, g = pair
    rnd = random.Random(7)
    h = tuple(hsm.h)
    x = ref.power(h, rnd.getrandbits(64))
    assert x == tuple(qfi.reduce_form(qfi.Form(*x)))
    y = ref.compose(x, h)
    assert y == tuple(qfi.compose(qfi.Form(*x), hsm.h))
    assert ref.compose(y, ref.neg(h)) == x
    assert ref.compose(x, x) == tuple(qfi.nudupl(qfi.Form(*x)))
    e = rnd.getrandbits(40)
    assert ref.power(h, e) == tuple(qfi.nupow(hsm.h, e))
    assert ref.power(h, 0) == g.identity


def test_subgroup_f(pair):
    hsm, g = pair
    rnd = random.Random(8)
    for m in [0, 1, 2, 3, g.M - 1, g.M // 2, rnd.randrange(g.M), rnd.randrange(g.M)]:
        fm = g.power_of_f(m)
        assert fm == tuple(hsm.power_of_f(m))
        assert g.dlog(fm) == m
    with pytest.raises(ValueError):
        g.dlog(tuple(hsm.h))


def test_fixed_base_powers_serial_and_in_parallel(pair):
    hsm, g = pair
    rnd = random.Random(9)
    x = ref.power(tuple(hsm.h), rnd.getrandbits(48))
    exps = [0, 1, 31, 32, rnd.getrandbits(70), rnd.getrandbits(70)]
    want = [ref.power(x, e) for e in exps]
    assert ref.powers(x, exps) == want
    got = ref.powers_in_parallel([(x, exps), (tuple(hsm.h), exps[:3])], workers=2)
    assert got == [want, [ref.power(tuple(hsm.h), e) for e in exps[:3]]]
    with pytest.raises(ValueError):
        ref.FixedBase(x, 8).power(1 << 10)
