"""The plain versions of the port's kernels against the JAX package's TPU
kernels, and (on a CUDA card only) the Hopper kernels against their plain
versions.

* K1 `xgcd_coeff_g`: cofhe_tpu_torch.ops.xgcd2 vs cofhe_tpu.ops.xgcd2 and
  pallas_group.xgcd_coeff_g in interpret mode, as tests/test_pallas.py runs
  it, plus math.gcd and the Bezout congruence.
* K2 `mod_topdown`: cofhe_tpu_torch.ops.rl vs cofhe_tpu.ops.rl and
  pallas_group.mod_topdown in interpret mode (edge cases of
  tests/test_pallas.py:50-52), plus Python's %.
* K3 `reduce2_grouped`: checked through compose2 in test_torch_forms2.py
  and against the JAX loop in test_torch_wide.py; here only its card test.

The wide schedules K2 and K3 compute (rl.mod_topdown28,
forms2.grouped_rho_loop_wide) are held against the JAX package in
test_torch_wide.py.

Tolerance: exact equality of the canonical outputs (d, cg, cu, x mod m,
reduced forms).
"""

import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cofhe_tpu.ops import pallas_group
from cofhe_tpu.ops import rl as jrl
from cofhe_tpu.ops import xgcd2 as jxgcd2
from cofhe_tpu_torch.ops import cuda_group
from cofhe_tpu_torch.ops import limb as lb

torch.set_num_threads(1)


def _pair(vals, L):
    a = lb.ints_to_limbs(vals, L)
    return torch.from_numpy(a), jnp.asarray(a)


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same(port, ref):
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert np.array_equal(_np(p), _np(r))


@pytest.mark.parametrize("need_u", [False, True])
def test_xgcd_plain_matches_jax(need_u):
    """tests/test_forms2.py:68-82 operands (1000 bits, edge cases)."""
    rng = random.Random(7)
    L, B, bits = 72, 64, 1000
    fs = [rng.randrange(1 << (bits - 1), 1 << bits) | 1 for _ in range(B)]
    gs = [rng.randrange(0, 1 << bits) for _ in range(B)]
    fs[0], gs[0] = 1, 0
    fs[1], gs[1] = 1, 5
    fs[2], gs[2] = 3, 0
    fs[3], gs[3] = 3, 6
    fs[4], gs[4] = (1 << 999) + 1, ((1 << 999) + 1) * 3
    fs[5], gs[5] = 2 ** 999 + 5, 2
    k = rng.randrange(1, 1 << 400) | 1
    fs[6], gs[6] = k * 9, k * 6
    (pf, jf), (pg, jg) = _pair(fs, L), _pair(gs, L)
    port = cuda_group.xgcd_coeff_g(pf, pg, pf, 1010, need_u=need_u)
    _same(port, jxgcd2.xgcd_coeff_g(jf, jg, jf, 1010, need_u=need_u))
    d, cg = lb.limbs_to_ints(port[0]), lb.limbs_to_ints(port[1])
    for i in range(B):
        assert d[i] == math.gcd(fs[i], gs[i]), i
        assert 0 <= cg[i] < fs[i] and (cg[i] * gs[i] - d[i]) % fs[i] == 0, i
    if need_u:
        cu = lb.limbs_to_ints(port[2])
        assert all((cu[i] * fs[i] + cg[i] * gs[i] - d[i]) % fs[i] == 0
                   for i in range(B))


@pytest.mark.parametrize("need_u", [False, True])
def test_xgcd_plain_matches_pallas_interpret(need_u):
    """tests/test_pallas.py:20-38: B=6 is a ragged batch for the TPU tile."""
    rng = random.Random(23)
    fs = [rng.getrandbits(190) | (1 << 189) | 1 for _ in range(6)]
    gs = [rng.getrandbits(188) for _ in range(6)]
    (pf, jf), (pg, jg) = _pair(fs, 16), _pair(gs, 16)
    port = cuda_group.xgcd_coeff_g_plain(pf, pg, pf, 200, need_u=need_u)
    _same(port, pallas_group.xgcd_coeff_g(jf, jg, jf, 200, need_u=need_u,
                                          interpret=True))


def test_mod_topdown_plain_matches_jax_and_pallas_interpret():
    """tests/test_pallas.py:41-61 inputs, with its edge cases (x = 0, -1 and
    2^630 - 1 against tiny moduli)."""
    rng = random.Random(41)
    L, Lm, B = 40, 24, 9
    xs = [rng.randrange(-(1 << 600), 1 << 600) for _ in range(B)]
    ms = [rng.randrange(1, 1 << 300) * 2 for _ in range(B)]
    xs[0], ms[0] = 0, 2
    xs[1], ms[1] = -1, 2
    xs[2], ms[2] = (1 << 630) - 1, 3
    sx, mx = lb.ints_to_signed(xs, L)
    x = sx[:, None] * mx
    pm, jm = _pair(ms, Lm)
    port = cuda_group.mod_topdown(torch.from_numpy(x), pm, 300)
    _same([port], [jrl.mod_topdown(jnp.asarray(x), jm, max_iters=300)])
    _same([port], [pallas_group.mod_topdown(jnp.asarray(x), jm, max_iters=300,
                                            tile=128, interpret=True)])
    assert lb.limbs_to_ints(port) == [a % b for a, b in zip(xs, ms)]


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_on_card(cuda_device):
    """K1, K2 and K3 on the card against their plain versions on the same
    card tensors, at the main path's widths with a ragged batch; K2 and K3
    also against the earlier plain versions (rl.mod_topdown,
    grouped_rho_loop)."""
    from cofhe_tpu_torch.core.cl_hsm2k import CLHSM2k
    from cofhe_tpu_torch.ops.engine import TorchEngine
    from cofhe_tpu_torch.ops.forms import bform_from_forms
    from cofhe_tpu_torch.ops.forms2 import grouped_rho_loop
    from cofhe_tpu_torch.ops.hostgmp import GmpClassGroup

    rng = random.Random(99)
    for W, nbits, need_u in ((88, 1392, False), (144, 2117, True), (8, 136, False)):
        bits = nbits - 40
        fs = [rng.getrandbits(bits) | 1 for _ in range(77)]
        gs = [rng.getrandbits(bits) for _ in range(77)]
        f = torch.from_numpy(lb.ints_to_limbs(fs, W)).to(cuda_device)
        g = torch.from_numpy(lb.ints_to_limbs(gs, W)).to(cuda_device)
        _same(cuda_group.xgcd_coeff_g_cuda(f, g, f, nbits, need_u),
              cuda_group.xgcd_coeff_g_plain(f, g, f, nbits, need_u))
    xs = [rng.getrandbits(4000) - (1 << 3999) for _ in range(77)]
    ms = [rng.getrandbits(2000) * 2 + 2 for _ in range(77)]
    sx, mx = lb.ints_to_signed(xs, 264)
    x = torch.from_numpy(sx[:, None] * mx).to(cuda_device)
    m = torch.from_numpy(lb.ints_to_limbs(ms, 144)).to(cuda_device)
    got = cuda_group.mod_topdown_cuda(x, m, 378)
    _same([got], [cuda_group.mod_topdown_plain(x, m, 378)])
    _same([got], [cuda_group.rl.mod_topdown(x, m, max_iters=378)])
    assert lb.limbs_to_ints(got) == [a % b for a, b in zip(xs, ms)]

    hsm = CLHSM2k(128, 128)
    cg = TorchEngine(hsm, cuda_device).cg
    gmp = GmpClassGroup(hsm.Delta)
    base = gmp.nupow_batch([hsm.h] * 8, [rng.getrandbits(1000) for _ in range(8)])
    f1 = [base[rng.randrange(8)] for _ in range(77)]
    f2 = [base[rng.randrange(8)] for _ in range(77)]
    a3, b3s, b3m, c3, _, _ = cg.compose2_unreduced(
        bform_from_forms(f1, cg.L, cuda_device), bform_from_forms(f2, cg.L, cuda_device))
    args = (a3, b3s[..., None] * b3m, c3, cg.dD_mant, cg.dD_top, cg.red_iters)
    raw = cuda_group.reduce2_grouped_loop_cuda(*args)
    # the wide loop gives the plain version's very limbs, and after the
    # exact tail the 2^12-budget loop's forms
    _same(raw, cuda_group.reduce2_grouped_loop_plain(*args))
    _same(cg._tail(*raw), cg._tail(*grouped_rho_loop(*args)))
