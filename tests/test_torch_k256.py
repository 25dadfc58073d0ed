"""sec=128, k=256: upstream's own network parameters (|Delta| of 2341 bits,
L = 160, Lm = 296), whose compose2 runs rows past the 288 limbs of every
k=128 kernel instance.

On the CPU, against Python integers: the plain versions of the kernels
that meet rows past 288 limbs in compose2 at k=256 (K2, K5m, K6a, K6e,
which have a wide instance, and K5d, whose c3 quotient has 160 limbs), at
their k=256 shapes, a few lanes each; the wrappers take rows of up to 320
limbs and refuse 321, and K5d's quotients stay within 288; CG's widths at 2341 bits are the benchmark configuration's;
the reference's dlog inverts its power of f at 256 bits; and a k=256
network (setup, three CoFHE nodes, compute node, client in this process)
decrypts a ct(2x2) of 256-bit plaintexts through UNARY DECRYPT. Its prime
is the smallest size the scheme takes at k=256 (f = (2^2k, 2^(k+1), 1 +
8p) is reduced only for 8p > 2^2k), 530 bits, and the CoFHE nodes' ladders
run on the host's GMP: sec=128 class-group arithmetic at k=256 is minutes
on the CPU's torch path.

On a card (`cuda`): each wide instance, and K5d on rows of 296 and 320
limbs, against its plain version at 512 and 16384 lanes, a k=256 compose2 at 512 lanes of ladder outputs against
the reference, and a k=128 compose2 that launches only narrow instances
with its launch keys unchanged.

Tolerance: exact equality of limbs, forms and plaintexts."""

import json
import os
import random

import numpy as np
import pytest
import torch

from cofhe_tpu_torch.ops import cuda_group
from cofhe_tpu_torch.ops import limb as lb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "portbench", "configs", "threshold-sec128-k256-t2n3.json")
# compose2's widths at sec=128, k=256
L, LH, LU, LM, LSQ, LDELTA = 160, 80, 224, 296, 152, 320

torch.set_num_threads(1)


def _rows(vals, W):
    return torch.as_tensor(lb.ints_to_limbs(vals, W), dtype=torch.int32)


def _ints(rows, sign=None):
    return lb.limbs_to_ints(rows.cpu(), None if sign is None else sign.cpu())


def _rand(rng, bits, n, odd=False):
    return [rng.getrandbits(bits) | (1 if odd else 0) for _ in range(n)]


# --------------------------------------------- the plain versions at k=256


def _k2_operands(rng, n):
    """mu_red's kind of x: s1 A - 2 s2 B limb by limb (signed, redundant)
    of two canonical Lm-limb rows, and m of about L limbs."""
    A, B = _rand(rng, 16 * LM - 20, n), _rand(rng, 16 * LM - 24, n)
    s1 = [rng.choice((-1, 1)) for _ in range(n)]
    s2 = [rng.choice((-1, 1)) for _ in range(n)]
    x = (torch.tensor(s1, dtype=torch.int32)[:, None] * _rows(A, LM)
         - 2 * torch.tensor(s2, dtype=torch.int32)[:, None] * _rows(B, LM))
    m = _rand(rng, 16 * L - 5, n)
    vals = [a * p - 2 * b * q for a, p, b, q in zip(s1, A, s2, B)]
    return x, _rows(m, L), vals, m


def test_k2_plain_reduces_296_limbs_by_160():
    rng = random.Random(2)
    x, m, vals, ms = _k2_operands(rng, 4)
    got = _ints(cuda_group.mod_topdown_plain(x, m, (2 * 16 * L) // 13 + 24))
    assert got == [v % q for v, q in zip(vals, ms)]


@pytest.mark.parametrize("La,Lb", [(LSQ, LSQ), (LU, LH), (320, 320)])
def test_k5m_plain_at_the_wide_shapes(La, Lb):
    rng = random.Random(La + Lb)
    Lo = LM if La < 320 else 320
    a, b = _rand(rng, 16 * La, 4), _rand(rng, 16 * Lb, 4)
    got = _ints(cuda_group.mag_mul_plain(_rows(a, La), _rows(b, Lb), Lo))
    assert got == [(x * y) % (1 << (16 * Lo)) for x, y in zip(a, b)]


def test_k5d_plain_c3_quotient_296_by_296_to_160():
    rng = random.Random(5)
    y = _rand(rng, 16 * (LM - L) - 3, 4, odd=True)
    q = _rand(rng, 16 * L, 4)
    got = _ints(cuda_group.mag_divexact_odd_plain(_rows([a * b for a, b in zip(y, q)], LM),
                                                  _rows(y, LM), L))
    assert got == q


def test_k6a_plain_csum_with_the_320_limb_delta_row():
    rng = random.Random(6)
    sq = _rand(rng, 16 * LM - 40, 4)
    d4 = rng.getrandbits(2339)
    sg, mag = cuda_group.canon_sm_plain([(_rows(sq, LM), None, 1),
                                         (_rows([d4], LDELTA), None, 1)], LM)
    assert _ints(mag, sg) == [s + d4 for s in sq]


def test_k6e_plain_at_296():
    rng = random.Random(7)
    a3 = [rng.getrandbits(16 * L - 310) << e for e in (0, 1, 17, 300)] + [0]
    csum = _rand(rng, 16 * LM, 5)
    cs_sh, a3_odd = cuda_group.c3_operands_plain(_rows(a3, L), _rows(csum, LM))
    es = [(a & -a).bit_length() - 1 if a else 16 * L for a in a3]
    assert _ints(a3_odd) == [a >> e for a, e in zip(a3, es)]
    assert _ints(cs_sh) == [c >> min(e, 16 * LM - 1) for c, e in zip(csum, es)]


# ------------------------------------------------- the wrappers' widths


def _zeros(*shape):
    return torch.zeros(shape, dtype=torch.int32)


WRAPPERS = {
    "mod_topdown": lambda W: cuda_group.mod_topdown_cuda(_zeros(2, W), _zeros(2, L), 64),
    "mag_mul": lambda W: cuda_group.mag_mul_cuda(_zeros(2, W), _zeros(2, LH), W),
    # K5d: dividend and divisor rows of W limbs, c3's quotient of L
    "divexact_odd": lambda W: cuda_group.mag_divexact_odd_cuda(_zeros(2, W), _zeros(2, W), L),
    "canon_sm": lambda W: cuda_group.canon_sm_cuda([(_zeros(2, W), None, 1)], W),
    "c3_operands": lambda W: cuda_group.c3_operands_cuda(_zeros(2, L), _zeros(2, W)),
}


@pytest.mark.parametrize("kernel", sorted(WRAPPERS))
def test_wide_wrappers_take_320_limbs_and_refuse_321(kernel):
    # 320 passes the width check and meets the device check (CPU tensors)
    with pytest.raises(ValueError, match="CUDA"):
        WRAPPERS[kernel](cuda_group.MAX_LIMBS)
    with pytest.raises(ValueError, match=str(cuda_group.MAX_LIMBS)):
        WRAPPERS[kernel](cuda_group.MAX_LIMBS + 1)
    assert cuda_group.MAX_LIMBS == 320
    assert (kernel in cuda_group.WIDE_KERNELS) == (kernel != "divexact_odd")


def test_k5d_quotients_stay_within_288_limbs():
    # no wide instance: its kernel reads only the quotient's limbs of x and y
    with pytest.raises(ValueError, match="CUDA"):
        cuda_group.mag_divexact_odd_cuda(_zeros(2, 320), _zeros(2, 320), 288)
    with pytest.raises(ValueError, match="outside"):
        cuda_group.mag_divexact_odd_cuda(_zeros(2, 320), _zeros(2, 320), 289)


def test_narrow_only_wrappers_keep_288():
    assert cuda_group.NARROW_LIMBS == 288
    with pytest.raises(ValueError, match="288"):
        cuda_group.redc_mod_cuda(_zeros(2, L), _zeros(2, L), L)


def test_wide_key_marks_rows_past_288():
    assert cuda_group.wide_key(("mod_topdown", 296, 160, 512))
    assert not cuda_group.wide_key(("mod_topdown", 264, 144, 512))
    assert cuda_group.wide_key(("mag_mul", 296, "152x152", 512))
    assert not cuda_group.wide_key(("mag_mul", 288, "288x288", 512))
    assert cuda_group.wide_key(("c3_operands", 296, 160, 512))
    assert cuda_group.wide_key(("c3_operands", 160, 320, 512))
    assert not cuda_group.wide_key(("divexact_odd", 160, "296x296", 512))
    assert not cuda_group.wide_key(("divexact_odd", 288, "320x320", 512))
    assert not cuda_group.wide_key(("xgcd_coeff_g", 320, 0, 512))


# --------------------------------------------- the configuration's widths


def test_cg_widths_at_2341_bits_are_the_configurations():
    from cofhe_tpu_torch.core.cl_hsm2k import _PRECOMPUTED_P, CLHSM2k
    from cofhe_tpu_torch.ops.engine import TorchEngine

    cfg = json.load(open(CONFIG))
    hsm = CLHSM2k(128, 256)
    assert hsm.p == _PRECOMPUTED_P[(128, 256)] == int(cfg["p"], 16)
    cg = TorchEngine(hsm, device="cpu").cg
    assert cg.disc_bits == (-hsm.Delta).bit_length() == cfg["disc_bits"] == 2341
    got = {w: getattr(cg, w) for w in ("L", "Lh", "Lxn", "Lu", "Lm", "Lsq")}
    got.update(W8=8, Ldelta=cg.delta4.shape[0])
    assert got == cfg["widths"]


def test_reference_dlog_inverts_power_of_f_at_256_bits():
    from portbench import reference as ref

    cfg = json.load(open(CONFIG))
    g = ref.CLGroup(int(cfg["p"], 16), 256)
    rng = random.Random(256)
    for m in [0, 1, (1 << 256) - 1] + [rng.getrandbits(256) for _ in range(5)]:
        assert g.dlog(g.power_of_f(m)) == m


# --------------------------------------------- a k=256 network on the CPU


def _prime(bits: int) -> int:
    from cofhe_tpu_torch.core.intmath import is_prime
    from cofhe_tpu_torch.core.rng import RandGen

    rg = RandGen(b"toy-prime:%d" % bits)
    while True:
        p = rg.random_bits(bits) | (1 << (bits - 1)) | 1
        if is_prime(p):
            return p


def test_k256_network_decrypts_256_bit_plaintexts_through_the_compute_node():
    from cofhe_tpu_torch.core import cl_hsm2k
    from portbench import deploy, reference, workload

    cfg = {"deployment": "threshold", "security_level": 128, "k": 256, "threshold": 2,
           "total_nodes": 3, "setup_device": "host", "cofhe_devices": ["host"] * 3,
           "compute_device": "cpu", "client_device": "cpu", "p": hex(_prime(530))}
    old = os.environ.get("COFHE_P_OVERRIDE")
    os.environ["COFHE_P_OVERRIDE"] = cfg["p"]
    cl_hsm2k._cached_params.cache_clear()
    try:
        group = reference.CLGroup(int(cfg["p"], 16), 256)
        dep = deploy.build(cfg, 2 ** 33 + 5, group.secretkey_bound)
        try:
            traffic = {"op": "decrypt", "ct_shape": [2, 2], "pool": 1}
            op, _ = workload.make(ROOT, dep, group, traffic, 2 ** 33 + 5)
            got = op.request(0)
            assert max(op.pool.pts[0]) >= 1 << 250  # 256-bit plaintexts
            assert got == op.pool.pts[0]
            assert op.compare()["wrong_plaintexts"] == (0, 0)
            assert op.compare(op.control())["wrong_plaintexts"][0] > 0
        finally:
            dep.close()
    finally:
        if old is None:
            os.environ.pop("COFHE_P_OVERRIDE", None)
        else:
            os.environ["COFHE_P_OVERRIDE"] = old
        cl_hsm2k._cached_params.cache_clear()


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the wide instances are Hopper kernels")
    return torch.device("cuda")


def _limb_rows(rng, B, W, top_bits=16):
    """B random canonical rows of W limbs (numpy, no Python integers)."""
    x = rng.integers(0, 1 << 16, size=(B, W), dtype=np.int64)
    x[:, -1] &= (1 << top_bits) - 1
    return torch.as_tensor(x.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [512, 16384])
def test_wide_instances_match_their_plain_versions_on_card(cuda_device, B):
    rng = np.random.default_rng(B)
    dev = cuda_device
    cuda_group.reset_launches()
    # K2: x (B, 296) signed and redundant mod m (B, 160)
    A, Bm = _limb_rows(rng, B, LM, 12), _limb_rows(rng, B, LM, 8)
    sg = torch.as_tensor(rng.choice([-1, 1], size=(B, 1)).astype(np.int32))
    x = (sg * A - 2 * Bm).to(dev)
    m = _limb_rows(rng, B, L, 11).to(dev)
    assert torch.equal(cuda_group.mod_topdown_cuda(x, m, 417),
                       cuda_group.mod_topdown_plain(x, m, 417))
    # K5m: sq, t1 and the widest product
    for La, Lb, Lo in ((LSQ, LSQ, LM), (LU, LH, LM), (320, 320, 320), (LU, LH, 289)):
        a, b = _limb_rows(rng, B, La).to(dev), _limb_rows(rng, B, Lb).to(dev)
        assert torch.equal(cuda_group.mag_mul_cuda(a, b, Lo),
                           cuda_group.mag_mul_plain(a, b, Lo)), (La, Lb, Lo)
    # K5d, narrow only: c3's quotient of 160 limbs from 296-limb rows, and
    # the widest quotient from 320-limb rows
    for Lx, Ly, Lo in ((LM, LM, L), (320, 320, 288)):
        xx = _limb_rows(rng, B, Lx).to(dev)
        yy = _limb_rows(rng, B, Ly)
        yy[:, 0] |= 1
        yy = yy.to(dev)
        assert torch.equal(cuda_group.mag_divexact_odd_cuda(xx, yy, Lo),
                           cuda_group.mag_divexact_odd_plain(xx, yy, Lo)), (Lx, Ly, Lo)
    # K6a: csum with the (1, 320) row, and a signed pair of sums at 320
    sq = _limb_rows(rng, B, LM, 8).to(dev)
    d4 = _limb_rows(rng, 1, LDELTA, 3).to(dev)
    terms = [(sq, None, 1), (d4, None, 1)]
    got, want = cuda_group.canon_sm_cuda(terms, LM), cuda_group.canon_sm_plain(terms, LM)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    s = torch.as_tensor(rng.choice([-1, 1], size=B).astype(np.int32)).to(dev)
    u, v = _limb_rows(rng, B, 320, 14).to(dev), _limb_rows(rng, B, 300).to(dev)
    pair = ([(u, s, 1), (v, None, -1)], [(v, s, 2)])
    got = cuda_group.canon_sm_cuda(pair[0], 320, shr=1, W_shr=300, terms2=pair[1])
    want = cuda_group.canon_sm_plain(pair[0], 320, shr=1, W_shr=300, terms2=pair[1])
    assert all(torch.equal(g, w) for gs, ws in zip(got, want) for g, w in zip(gs, ws))
    # K6e: a3 (B, 160) with trailing zeros, csum (B, 296); and 320 / 320
    for La, Lc in ((L, LM), (320, 320)):
        a3 = _limb_rows(rng, B, La)
        a3[:, : rng.integers(0, 4)] = 0
        a3[::7] = 0
        a3, cs = a3.to(dev), _limb_rows(rng, B, Lc).to(dev)
        got, want = cuda_group.c3_operands_cuda(a3, cs), cuda_group.c3_operands_plain(a3, cs)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (La, Lc)
    torch.cuda.synchronize()
    wide = dict(cuda_group.WIDE_LAUNCHES)
    assert wide == {"mod_topdown": 1, "mag_mul": 4, "canon_sm": 2, "c3_operands": 2}


def _engine(k: int, device):
    from cofhe_tpu_torch.core.cl_hsm2k import CLHSM2k
    from cofhe_tpu_torch.ops.engine import TorchEngine

    return TorchEngine(CLHSM2k(128, k), device=device)


def _ladder_forms(eng, B: int, seed: int):
    """B distinct forms on the card: h^1 .. h^B by doubling batches, then
    raised together to one random exponent by the engine's wNAF ladder (the
    CoFHE nodes' part-decryption)."""
    from cofhe_tpu_torch.core.cl_hsm2k import CipherText
    from cofhe_tpu_torch.ops.forms import BForm, bform_from_forms, bform_to_forms

    cg, hsm = eng.cg, eng.hsm
    pw = bform_from_forms([hsm.h], cg.L, eng.device)
    last = pw
    while pw.a.shape[0] < B:
        n = pw.a.shape[0]
        step = BForm(*(x.expand(n, *x.shape[1:]).contiguous() for x in last))
        nxt = cg.compose2_eager(pw, step)
        pw = BForm(*(torch.cat([x, y]) for x, y in zip(pw, nxt)))
        last = BForm(*(x[-1:] for x in pw))
    forms = bform_to_forms(pw)
    share = random.Random(seed).getrandbits(1200)
    return eng.part_decrypt_batch(share, [CipherText(f, f) for f in forms])


@pytest.mark.cuda
def test_k256_compose2_of_ladder_outputs_equals_the_reference(cuda_device):
    from cofhe_tpu_torch.ops.forms import bform_from_forms, bform_to_forms
    from portbench import reference as ref

    eng = _engine(256, cuda_device)
    cg = eng.cg
    assert (cg.L, cg.Lm) == (L, LM)
    forms = _ladder_forms(eng, 512, 256)
    F1 = bform_from_forms(forms, L, cuda_device)
    F2 = bform_from_forms(forms[1:] + forms[:1], L, cuda_device)
    cuda_group.reset_launches()
    eager = bform_to_forms(cg.compose2_eager(F1, F2))
    torch.cuda.synchronize()
    wide = dict(cuda_group.WIDE_LAUNCHES)
    replayed = bform_to_forms(cg.compose2(F1, F2))  # the captured graph
    want = [ref.compose((x.a, x.b, x.c), (y.a, y.b, y.c))
            for x, y in zip(forms, forms[1:] + forms[:1])]
    assert [(f.a, f.b, f.c) for f in eager] == want
    assert [(f.a, f.b, f.c) for f in replayed] == want
    # one launch a compose2 of each wide instance compose2 reaches: K2's mu,
    # K5m's t1 and sq, K6a's csum and K6e; c3's quotient has 160 limbs
    assert wide == {"mod_topdown": 1, "mag_mul": 2, "canon_sm": 1, "c3_operands": 1}


# the launch keys of one k=128 compose2 at 512 lanes, as the tree before
# the wide instances gave them on the card
K128_KEYS_512 = {
    ("c3_operands", 264, 144, 512): 1, ("canon_sm", 144, "144", 512): 1,
    ("canon_sm", 144, "144+144>>1:136", 512): 1, ("canon_sm", 144, "72+144", 512): 1,
    ("canon_sm", 264, "264+288", 512): 1, ("compose_prologue", 144, "72,Lxn=88", 512): 1,
    ("divexact_odd", 72, "144x144", 512): 1, ("divexact_odd", 72, "144x72", 512): 1,
    ("divexact_odd", 144, "144x72", 512): 1, ("divexact_odd", 144, "264x264", 512): 1,
    ("gcd2_merge", 72, 8, 512): 1, ("gcd_bridge", 144, "Lxn=88,Lh=72", 512): 1,
    ("mag_mul", 144, "72x144", 512): 3, ("mag_mul", 144, "72x72", 512): 1,
    ("mag_mul", 200, "72x144", 512): 1, ("mag_mul", 264, "136x136", 512): 1,
    ("mag_mul", 264, "200x72", 512): 1, ("mod_topdown", 264, 144, 512): 1,
    ("redc_mod", 8, 8, 512): 1, ("redc_mod", 72, 72, 512): 3,
    ("reduce2_grouped", 144, 0, 512): 1, ("reduce_exact", 144, 0, 512): 1,
    ("xgcd_coeff_g", 8, 136, 512): 1, ("xgcd_coeff_g", 72, 1152, 512): 1,
    ("xgcd_coeff_g", 88, 1392, 512): 1, ("xgcd_coeff_g", 144, 2117, 512): 1}


@pytest.mark.cuda
def test_k128_compose2_launches_only_narrow_instances(cuda_device):
    from cofhe_tpu_torch.ops.forms import bform_from_forms

    eng = _engine(128, cuda_device)
    cg = eng.cg
    forms = _ladder_forms(eng, 512, 128)
    F1 = bform_from_forms(forms, cg.L, cuda_device)
    F2 = bform_from_forms(forms[1:] + forms[:1], cg.L, cuda_device)
    cuda_group.reset_launches()
    cg.compose2_eager(F1, F2)
    torch.cuda.synchronize()
    keys = dict(cuda_group.LAUNCHES_BY_KEY)
    assert set(cuda_group.WIDE_LAUNCHES.values()) == {0}
    assert keys == K128_KEYS_512
