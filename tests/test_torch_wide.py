"""The wide schedules of K2 and K3 (the plain versions the Hopper kernels
compute) against the JAX package, on the CPU.

* K2: cofhe_tpu_torch.ops.rl.mod_topdown28 (28-bit digits) against the JAX
  package's rl.mod_topdown28 and rl.mod_topdown, and Python's %, on the
  inputs of tests/test_forms2.py:165-185 and on lanes of the mu
  reduction's sec=128 widths (x 264 limbs, m 144). The port departs from
  the JAX digit_est in two places; `test_jax_mod_topdown28_faults_pinned`
  shows the lanes where the JAX loop does not finish and the port does.
* K3: cofhe_tpu_torch.ops.compose2_plain.grouped_rho_loop_wide followed
  by the exact tail against the JAX package's CG.reduce2_grouped on the operand
  classes of tests/test_forms2.py:106-217 (identities, self-composes,
  inverse pairs, powers of f) at k=32, and on a few sec=128 lanes; its
  group count against the 2^12-budget loop (forms2.grouped_rho_loop), and
  its red_iters cap ahead of the exact tail.
* The helpers the wide schedules add (spread_carry, value_est_wide), the
  CPU dispatch to the wide plain versions, and the kernels' wrappers
  refusing CPU tensors.

Tolerance: exact equality of canonical outputs (x mod m, reduced forms);
the helpers' outputs exactly equal Python integers.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofhe_tpu.core.qfi import identity_form, neg, nupow, reduce_form
from cofhe_tpu.ops import rl as jrl
from cofhe_tpu.ops.forms import bform_to_forms as jbform_to_forms
from cofhe_tpu_torch.ops import compose2_plain as c2p
from cofhe_tpu_torch.ops import cuda_group, rl
from cofhe_tpu_torch.ops import forms2 as f2m
from cofhe_tpu_torch.ops import limb as lb
from cofhe_tpu_torch.ops.forms import bform_from_forms, bform_to_forms
from test_torch_forms2 import _cgs, _tuples

torch.set_num_threads(1)

LX, LM, MU_ITERS = 264, 144, 378  # the mu reduction at sec=128


def _signed(xs, L):
    sx, mx = lb.ints_to_signed(xs, L)
    return sx[:, None] * mx


def _ints(t):
    return lb.limbs_to_ints(torch.as_tensor(np.array(t)))


# ------------------------------------------------------------------- K2


def _forms2_inputs():
    """tests/test_forms2.py:165-185."""
    rng = random.Random(3)
    L, B = 40, 64
    xs = [rng.randrange(-(1 << 500), 1 << 500) for _ in range(B)]
    ms = [rng.randrange(1, 1 << 300) for _ in range(B)]
    xs[0], ms[0] = 0, 1
    xs[1], ms[1] = -1, 1
    xs[2], ms[2] = 12345, 1
    xs[3], ms[3] = -(1 << 400), 3
    xs[4], ms[4] = (1 << 499) + 7, (1 << 499) + 7
    xs[5], ms[5] = (1 << 499) + 6, (1 << 499) + 7
    xs[6], ms[6] = -((1 << 499) + 8), (1 << 499) + 7
    xs[7], ms[7] = (1 << 500) - 1, 5
    return xs, ms, _signed(xs, L + 4), lb.ints_to_limbs(ms, L)


def _sec128_inputs(rng, B=12):
    """Lanes of the mu reduction's widths: random x (2000-4150 bits) and
    even m (1000-2080 bits), with the wide digit's edge cases: x = +-k*m,
    x = m - 1, x at the top of the 264 limbs over tiny m (j clipped at
    L - 2 - top_m), and x = 0."""
    xs = [rng.getrandbits(rng.randrange(2000, 4150)) * rng.choice((1, -1))
          for _ in range(B)]
    ms = [rng.getrandbits(rng.randrange(1000, 2080)) * 2 + 2 for _ in range(B)]
    k = rng.getrandbits(2000) | 1
    top = (1 << (16 * (LX - 1) + 15)) - 1
    edge = [(k * ms[0], ms[0]), (-k * ms[1], ms[1]), (ms[2] - 1, ms[2]),
            (top, 2), (-top, 6), (0, ms[5])]
    for i, (x, m) in enumerate(edge):
        xs[i], ms[i] = x, m
    return xs, ms, _signed(xs, LX), lb.ints_to_limbs(ms, LM)


def test_mod_topdown28_matches_jax_on_forms2_inputs():
    xs, ms, x, m = _forms2_inputs()
    want = [a % b for a, b in zip(xs, ms)]
    iters = torch.zeros(len(xs), dtype=torch.int32)
    port = rl.mod_topdown28(torch.from_numpy(x), torch.from_numpy(m),
                            max_iters=600, iters=iters)
    assert lb.limbs_to_ints(port) == want
    ref28 = jrl.mod_topdown28(jnp.asarray(x), jnp.asarray(m), max_iters=600)
    assert np.array_equal(port.numpy(), np.asarray(ref28))
    ref = jrl.mod_topdown(jnp.asarray(x), jnp.asarray(m), max_iters=600)
    assert np.array_equal(port.numpy(), np.asarray(ref))
    assert int(iters.max()) < 600


@pytest.mark.parametrize("seed", [5, 17])
def test_mod_topdown28_matches_jax_mod_topdown_at_sec128(seed):
    xs, ms, x, m = _sec128_inputs(random.Random(seed))
    want = [a % b for a, b in zip(xs, ms)]
    iters = torch.zeros(len(xs), dtype=torch.int32)
    port = cuda_group.mod_topdown(torch.from_numpy(x), torch.from_numpy(m),
                                  MU_ITERS)
    assert lb.limbs_to_ints(port) == want
    plain = rl.mod_topdown28(torch.from_numpy(x), torch.from_numpy(m),
                             max_iters=MU_ITERS, iters=iters)
    assert torch.equal(plain, port)
    ref = jrl.mod_topdown(jnp.asarray(x), jnp.asarray(m), max_iters=MU_ITERS)
    assert np.array_equal(port.numpy(), np.asarray(ref))
    assert np.array_equal(port.numpy(), rl.mod_topdown(
        torch.from_numpy(x), torch.from_numpy(m), max_iters=MU_ITERS).numpy())
    # 28-bit digits: the random lanes need ~(bits(x) - bits(m)) / 24
    # iterations; x = 2^4223 over m = 2 needs ~4223 / 28
    assert int(iters.max()) < MU_ITERS


def test_jax_mod_topdown28_faults_pinned():
    """The JAX package's mod_topdown28 clips j to L - 2 - top_m after its
    digit was taken for the unclipped j, so for x at the top of the 264
    limbs over a tiny m each digit removes ~2^-16 of what it should and the
    loop never finishes; the port clips j first. The JAX digit_est also
    clamps the scale at 2^30, which cuts digits when mant(x) / mant(m) is
    small; the port clamps at 2^60 (the digit clamp is the real bound)."""
    top = (1 << (16 * (LX - 1) + 15)) - 1
    xs, ms = [top, -top, 12345], [2, 6, 7]
    x, m = _signed(xs, LX), lb.ints_to_limbs(ms, LM)
    want = [a % b for a, b in zip(xs, ms)]
    port = rl.mod_topdown28(torch.from_numpy(x), torch.from_numpy(m),
                            max_iters=MU_ITERS)
    assert lb.limbs_to_ints(port) == want
    ref28 = _ints(jrl.mod_topdown28(jnp.asarray(x), jnp.asarray(m),
                                    max_iters=4 * MU_ITERS))
    assert ref28[:2] != want[:2] and ref28[2] == want[2]
    # the scale clamp: x = 2^(16*10), m ~ 2^15 * 2^(16*2): ratio of the
    # mantissas 2^-15, exponent gap 8 limbs
    xv, mv = [1 << 160], [(1 << 47) - 1]
    xt, mt = torch.from_numpy(lb.ints_to_limbs(xv, 16)), torch.from_numpy(
        lb.ints_to_limbs(mv, 16))
    (mx, tx), (mm, tm) = rl.value_est(xt), rl.value_est(mt)
    qd, j = rl.digit_est(mx, tx, mm, tm, 28)
    jqd, jj = jrl.digit_est(jnp.asarray(mx.numpy()), jnp.asarray(tx.numpy()),
                            jnp.asarray(mm.numpy()), jnp.asarray(tm.numpy()), 28)
    assert int(j[0]) == int(jj[0])
    q_true = xv[0] // (mv[0] << (16 * int(j[0])))
    assert abs(int(qd[0]) - q_true) <= 1
    assert int(jqd[0]) < q_true // 2


# ------------------------------------------------------------------- K3


def _rho_operands(hsm, B, seed):
    """tests/test_forms2.py:188-217 classes: identities, a self-compose,
    inverse pairs (freak quotients that fall to the exact tail), powers of
    f, random pairs."""
    rng = random.Random(seed)
    ident = identity_form(hsm.Delta)
    pool = [nupow(hsm.h, rng.randrange(1, 1 << 60)) for _ in range(16)]
    f1 = [pool[rng.randrange(len(pool))] for _ in range(B)]
    f2 = [pool[rng.randrange(len(pool))] for _ in range(B)]
    f1[0] = ident
    f2[1] = ident
    f1[2] = f2[2]
    f1[3] = reduce_form(neg(f2[3]))
    f1[4] = reduce_form(neg(f2[4]))
    f1[5] = hsm.power_of_f(3)
    f2[5] = hsm.power_of_f(7)
    return f1, f2


def _check_wide_against_jax(hsm, f1, f2):
    jcg, pcg, L = _cgs(hsm)
    a3, b3s, b3m, c3, *_ = pcg.compose2_unreduced(
        bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu"))
    bred = b3s[..., None] * b3m
    args = (pcg.dD_mant, pcg.dD_top, pcg.red_iters)
    B = len(f1)
    it_w = torch.zeros(B, dtype=torch.int64)
    it_o = torch.zeros(B, dtype=torch.int32)
    wide = _tuples(bform_to_forms(pcg._tail(
        *c2p.grouped_rho_loop_wide(a3, bred, c3, *args, iters=it_w))))
    old = _tuples(bform_to_forms(pcg._tail(
        *f2m.grouped_rho_loop(a3, bred, c3, *args, iters=it_o))))
    out = jax.tree.map(np.asarray, jax.jit(jcg.reduce2_grouped)(
        a3.numpy(), bred.numpy(), c3.numpy()))
    assert wide == _tuples(jbform_to_forms(type(out)(*out)))
    assert wide == old
    # the dispatcher sends CPU tensors to the wide loop
    disp = _tuples(bform_to_forms(pcg.reduce2_grouped(a3, bred, c3)))
    assert disp == wide
    assert torch.all(it_w <= it_o.long()) and int(it_w.sum()) < int(it_o.sum())
    return it_w, it_o


def test_wide_rho_loop_matches_jax_at_k32(toy_hsm):
    f1, f2 = _rho_operands(toy_hsm, 32, 11)
    _check_wide_against_jax(toy_hsm, f1, f2)


def test_wide_rho_loop_matches_jax_at_sec128():
    from cofhe_tpu.core.cl_hsm2k import CLHSM2k

    hsm = CLHSM2k(128, 128)
    rng = random.Random(5)
    pool = [nupow(hsm.h, rng.getrandbits(200)) for _ in range(6)]
    B = 8
    f1 = [pool[rng.randrange(6)] for _ in range(B)]
    f2 = [pool[rng.randrange(6)] for _ in range(B)]
    f1[0] = f2[0]
    f1[1] = reduce_form(neg(f2[1]))
    f1[2] = hsm.power_of_f(3)
    f2[2] = hsm.power_of_f(7)
    it_w, it_o = _check_wide_against_jax(hsm, f1, f2)
    # random lanes: 2^22-budget groups take well under half of the
    # 2^12-budget loop's
    assert int(it_w[3:].sum()) * 2 < int(it_o[3:].sum())


# -------------------------------------------------------------- helpers


@pytest.mark.parametrize("ndig", [3, 4])
def test_spread_carry_keeps_value_and_bounds_limbs(ndig):
    rng = random.Random(ndig)
    B, L = 16, 24
    lim = 1 << (16 * ndig - 3)
    s = torch.tensor([[rng.randrange(-lim, lim) for _ in range(L)]
                      for _ in range(B)], dtype=torch.int64)
    s[:, L - ndig:] = torch.randint(-(1 << 15), 1 << 15, (B, ndig))
    out = rl.spread_carry(s, ndig)
    assert out.dtype == torch.int32
    for i in range(B):
        want = sum(int(v) << (16 * k) for k, v in enumerate(s[i].tolist()))
        got = sum(int(v) << (16 * k) for k, v in enumerate(out[i].tolist()))
        assert got == want, i
    assert int(out[:, :L - 1].abs().max()) <= ndig * (1 << 15)


def test_value_est_wide_matches_python():
    rng = random.Random(2)
    vals = [rng.getrandbits(rng.randrange(1, 1500)) * rng.choice((1, -1))
            for _ in range(31)] + [0]
    sx, mx = lb.ints_to_signed(vals, 100)
    x = rl.carry2(torch.from_numpy(sx[:, None] * mx))
    mant, top = rl.value_est_wide(x)
    for i, v in enumerate(vals):
        if v == 0:
            assert float(mant[i]) == 0.0 and int(top[i]) == 0
            continue
        # four limbs: the limbs below reach 2^-48 of the top limb's scale,
        # and a balanced value is at least 2^-1.01 of it
        exact = v / (1 << (16 * int(top[i])))  # correctly rounded
        assert abs(float(mant[i]) - exact) <= abs(exact) * 2.0 ** -46, i


def test_wide_rho_loop_stops_at_red_iters_and_tail_finishes(toy_hsm):
    """The red_iters cap holds, and a loop cut short by it leaves forms
    that the exact tail still takes to the same reduced forms."""
    _, pcg, L = _cgs(toy_hsm)
    f1, f2 = _rho_operands(toy_hsm, 16, 23)
    a3, b3s, b3m, c3, *_ = pcg.compose2_unreduced(
        bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu"))
    args = (a3, b3s[..., None] * b3m, c3, pcg.dD_mant, pcg.dD_top)
    full_it = torch.zeros(16, dtype=torch.int64)
    full = c2p.grouped_rho_loop_wide(*args, pcg.red_iters, iters=full_it)
    cap = int(full_it.max()) // 2
    assert cap >= 1
    cut_it = torch.zeros(16, dtype=torch.int64)
    cut = c2p.grouped_rho_loop_wide(*args, cap, iters=cut_it)
    assert torch.equal(cut_it, full_it.clamp(max=cap))
    assert _tuples(bform_to_forms(pcg._tail(*cut))) \
        == _tuples(bform_to_forms(pcg._tail(*full)))


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: the kernels' wrappers raise on CPU tensors."""
    x = torch.zeros((2, LX), dtype=torch.int32)
    m = torch.ones((2, LM), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_group.mod_topdown_cuda(x, m, MU_ITERS)
    a = torch.zeros((2, LM), dtype=torch.int32)
    with pytest.raises(ValueError):
        cuda_group.reduce2_grouped_loop_cuda(a, a, a, 1.0, 130, 416)
