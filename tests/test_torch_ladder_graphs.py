"""The wNAF ladder with its state on the card (ops/graphs.py `LadderSteps`,
`LadderGraphs`): on the CPU, the two step bodies that the graphs capture,
driven by the digit plan and its counter, against core.qfi.nupow and the
host compose; the plan's bank rows; the steps read nothing on the host
(the host-read guard of test_torch_graphs.py); the CPU's `wnaf_segment`
runs them eagerly and caches no graphs. On a CUDA card only: the ladder
graphs at 512 lanes against the per-replay ladder and the eager steps,
their launch counts, two threads decrypting on one engine, a NUCOMP CG's
ladder.

Toy fixtures; lanes: powers of h, h itself, f and an identity. Tolerance:
exact equality of the reduced forms.
"""

import collections
import random
import threading

import pytest
import torch

from cofhe_tpu.core.qfi import compose, identity_form, neg, nudupl, nupow, reduce_form
from cofhe_tpu_torch.ops import cuda_group, graphs
from cofhe_tpu_torch.ops.forms import BForm, bform_from_forms, bform_neg, bform_to_forms
from cofhe_tpu_torch.ops.graphs import LadderGraphs, LadderSteps, wnaf_plan
from cofhe_tpu_torch.ops.nupow2 import (identity_bform2, make_wnaf_bank, wnaf_digits,
                                        wnaf_segment)
from test_torch_forms2 import _cgs, _tuples
from test_torch_graphs import _guarded, _NoSync, _opaque_kernels, _plain

torch.set_num_threads(1)

W = 5


def _lanes(hsm, rng, n_powers: int) -> list:
    base = [nupow(hsm.h, rng.randrange(1, 1 << 40)) for _ in range(n_powers)]
    return base + [hsm.h, hsm.f, identity_form(hsm.Delta)]


def _host_segment(bank_forms, r, sched) -> list:
    """wnaf_segment on the host: per lane, a nudupl a digit, then a compose
    with bank slot (|d| - 1) / 2, inverted for d < 0."""
    for d in sched:
        r = [nudupl(f) for f in r]
        if d:
            t = bank_forms[(abs(d) - 1) // 2]
            r = [compose(f, u if d > 0 else neg(u)) for f, u in zip(r, t)]
    return r


def _exponent(rng, bits: int) -> int:
    """A `bits`-bit exponent whose wNAF stream has a negative digit."""
    while True:
        e = rng.getrandbits(bits) | (1 << (bits - 1))
        if min(wnaf_digits(e, W)) < 0:
            return e


# (seed, exponent bits, zeros padded in front, PLAN_ROWS: 2 uploads the
# plan again every 2 nonzero digits)
CASES = [(11, 24, 6, graphs.PLAN_ROWS), (12, 31, 0, graphs.PLAN_ROWS), (13, 18, 3, 2)]


@pytest.mark.parametrize("seed,bits,pad,plan_rows", CASES)
def test_ladder_steps_match_wnaf_segment_and_nupow(toy_hsm, monkeypatch, seed, bits, pad,
                                                   plan_rows):
    _, pcg, L = _cgs(toy_hsm)
    monkeypatch.setattr(graphs, "PLAN_ROWS", plan_rows)
    rng = random.Random(seed)
    base = _lanes(toy_hsm, rng, 3)
    e = _exponent(rng, bits)
    sched = [0] * pad + wnaf_digits(e, W)
    pb = bform_from_forms(base, L, "cpu")
    bank = make_wnaf_bank(pcg, pb, W)
    ident = identity_bform2(pcg, len(base))
    steps = LadderSteps(pcg, bank, ident)
    assert _tuples(bform_to_forms(steps.run(bank, ident, sched))) == \
        _tuples(nupow(f, e) for f in base)
    rows = wnaf_plan(sched, bank.a.shape[0])
    # the counter stopped after the last upload's rows
    assert int(steps.plan[0]) == (len(rows) - 1) % plan_rows + 1
    # the state reloads: a second call from another start
    got = steps.run(bank, pb, sched[:9])
    odd = [[nupow(f, 2 * i + 1) for f in base] for i in range(bank.a.shape[0])]
    assert _tuples(bform_to_forms(got)) == _tuples(_host_segment(odd, base, sched[:9]))


def test_plan_gives_each_nonzero_digit_its_slot_and_sign(toy_hsm):
    rng = random.Random(21)
    S = 1 << (W - 2)
    for _ in range(20):
        sched = wnaf_digits(rng.getrandbits(200), W)
        rows = wnaf_plan(sched, S)
        nonzero = [d for d in sched if d]
        assert len(rows) == len(nonzero)
        for d, row in zip(nonzero, rows):
            assert row % S == (abs(d) - 1) // 2
            assert (row >= S) == (d < 0)
    for bad in ([0, 2], [17], [-17]):
        with pytest.raises(ValueError, match="odd digit"):
            wnaf_plan(bad, S)
    # the bank's rows S.. carry the inverses' signs
    _, pcg, L = _cgs(toy_hsm)
    pb = bform_from_forms(_lanes(toy_hsm, rng, 2), L, "cpu")
    bank = make_wnaf_bank(pcg, pb, W)
    steps = LadderSteps(pcg, bank, pb)
    steps._load(bank, pb)
    assert torch.equal(steps.bank.b_sign[:S], bank.b_sign)
    assert torch.equal(steps.bank.b_sign[S:], bform_neg(bank).b_sign)
    for x, y in zip((steps.bank.a, steps.bank.b, steps.bank.c), (bank.a, bank.b, bank.c)):
        assert torch.equal(x, y)


def test_ladder_steps_read_nothing_on_the_host(toy_hsm, monkeypatch):
    """S and SC, the bodies the graphs capture, on guarded state with the
    kernels opaque: no host read, and the forms of nudupl2 and of
    compose2(nudupl2(r), inverse of bank slot 2)."""
    _, pcg, L = _cgs(toy_hsm)
    rng = random.Random(31)
    base = _lanes(toy_hsm, rng, 5)
    pb = bform_from_forms(base, L, "cpu")
    bank = make_wnaf_bank(pcg, pb, W)
    S = bank.a.shape[0]
    steps = LadderSteps(pcg, bank, pb)
    steps._load(bank, pb)
    steps._upload([2 + S])
    steps.r, steps.bank = _guarded(steps.r), _guarded(steps.bank)
    steps.plan = steps.plan.as_subclass(_NoSync)
    with _opaque_kernels(monkeypatch):
        steps.square()
        steps.square_mul()
    assert isinstance(steps.r.a, _NoSync)
    assert int(_plain(steps.plan)[0]) == 1
    sq = [nupow(f, 4) for f in base]
    t = [reduce_form(neg(nupow(f, 5))) for f in base]
    want = [compose(a, b) for a, b in zip(sq, t)]
    got = bform_to_forms(BForm(*(_plain(x) for x in steps.r)))
    assert _tuples(got) == _tuples(want)


def test_cpu_wnaf_segment_runs_the_ladder_steps(toy_hsm, monkeypatch):
    """On the CPU wnaf_segment goes through run_ladder into the ladder's
    steps run eagerly, a fresh LadderSteps a call, and caches no
    LadderGraphs, which refuses a CPU device."""
    _, pcg, L = _cgs(toy_hsm)
    ran = []
    run_ladder, run = pcg.compose_graphs.run_ladder, LadderSteps.run

    def spy_ladder(*a):
        ran.append("run_ladder")
        return run_ladder(*a)

    def spy_run(steps, *a):
        ran.append(steps)
        return run(steps, *a)

    monkeypatch.setattr(pcg.compose_graphs, "run_ladder", spy_ladder)
    monkeypatch.setattr(LadderSteps, "run", spy_run)
    base = _lanes(toy_hsm, random.Random(41), 1)
    pb = bform_from_forms(base, L, "cpu")
    bank = make_wnaf_bank(pcg, pb, W)
    for _ in range(2):
        got = wnaf_segment(pcg, bank, pb, [1, 0, -3])
    assert [x if x == "run_ladder" else type(x) for x in ran] == \
        ["run_ladder", LadderSteps] * 2 and ran[1] is not ran[3]
    # from r = f: f^2 * f, then squared, then squared again times f^-3
    assert _tuples(bform_to_forms(got)) == _tuples(nupow(f, 9) for f in base)
    assert pcg.compose_graphs.ladders == {}
    with pytest.raises(ValueError, match="CUDA graphs"):
        LadderGraphs(pcg, bank, pb)


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the Hopper kernels")
    return torch.device("cuda")


def _card(device, lanes=512, seed=51, use_nucomp=False):
    from conftest import toy_prime
    from cofhe_tpu_torch.core.cl_hsm2k import CLHSM2k
    from cofhe_tpu_torch.ops.engine import TorchEngine
    from cofhe_tpu_torch.ops.forms2 import CG

    hsm = CLHSM2k(128, 32, p=toy_prime(100))
    eng = TorchEngine(hsm, device)
    cg = eng.cg
    if use_nucomp:
        cg = CG(cg.disc_bits, cg.delta4, cg.h, cg.h2, use_nucomp=True)
    rng = random.Random(seed)
    pool = [nupow(hsm.h, rng.randrange(1, 1 << 60)) for _ in range(32)]
    forms = [pool[rng.randrange(32)] for _ in range(lanes - 2)]
    forms += [hsm.f, identity_form(hsm.Delta)]
    return hsm, eng, cg, forms, rng


def _kinds(rec) -> dict:
    kinds = collections.Counter()
    for key, n in rec.per_replay.items():
        kinds[key[0]] += n
    return dict(kinds)


def _per_replay_segment(cg, bank, r, sched):
    """The ladder as it ran before its graphs: a compose2 replay a step."""
    for d in sched:
        r = cg.nudupl2(r)
        if d:
            idx = (abs(d) - 1) // 2
            t = BForm(*(x[idx] for x in bank))
            r = cg.compose2(r, bform_neg(t) if d < 0 else t)
    return r


@pytest.mark.cuda
def test_ladder_graphs_equal_the_per_replay_ladder_on_card(cuda_device):
    hsm, _, cg, forms, rng = _card(cuda_device)
    e = _exponent(rng, 120)
    sched = [0] * 5 + wnaf_digits(e, W)
    bf = bform_from_forms(forms, cg.L, cuda_device)
    bank = make_wnaf_bank(cg, bf, W)
    ident = identity_bform2(cg, len(forms))
    got = wnaf_segment(cg, bank, ident, sched)
    assert len(cg.compose_graphs.ladders) == 1
    want = _per_replay_segment(cg, bank, ident, sched)
    eager = LadderSteps(cg, bank, ident).run(bank, ident, sched)
    for x, y, z in zip(got, want, eager):
        assert torch.equal(x, y) and torch.equal(x, z)
    assert _tuples(bform_to_forms(got))[-3:] == _tuples(nupow(f, e) for f in forms[-3:])
    # again, from the previous result: the state reloads
    again = wnaf_segment(cg, bank, got, sched[:40])
    for x, y in zip(again, _per_replay_segment(cg, bank, got, sched[:40])):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_ladder_launches_are_the_step_graphs_keys_times_launches_on_card(cuda_device):
    _, _, cg, forms, rng = _card(cuda_device, lanes=256, seed=52)
    sched = wnaf_digits(_exponent(rng, 90), W)
    bf = bform_from_forms(forms, cg.L, cuda_device)
    bank = make_wnaf_bank(cg, bf, W)
    ident = identity_bform2(cg, len(forms))
    wnaf_segment(cg, bank, ident, sched)  # warm-ups, captures, one call
    (lg,) = cg.compose_graphs.ladders.values()
    s_rec, sc_rec = lg.launches
    # SC runs two compose2s' kernels, S one
    assert _kinds(sc_rec) == {k: 2 * n for k, n in _kinds(s_rec).items()}
    replays = {k: g.replays for k, g in cg.compose_graphs.graphs.items()}
    for _ in range(2):
        by_key = dict(cuda_group.LAUNCHES_BY_KEY)
        steps = lg.steps
        wnaf_segment(cg, bank, ident, sched)
        nonzero = sum(1 for d in sched if d)
        want = collections.Counter()
        for rec, n in ((s_rec, len(sched) - nonzero), (sc_rec, nonzero)):
            for k, c in rec.per_replay.items():
                want[k] += c * n
        got = {k: v - by_key.get(k, 0) for k, v in cuda_group.LAUNCHES_BY_KEY.items()}
        assert {k: v for k, v in got.items() if v} == dict(want)
        assert lg.steps - steps == len(sched)
    assert {k: g.replays for k, g in cg.compose_graphs.graphs.items()} == replays


@pytest.mark.cuda
def test_two_threads_decrypt_on_one_engine_on_card(cuda_device):
    hsm, eng, _, forms, rng = _card(cuda_device, lanes=128, seed=53)
    cts = [type("Ct", (), {"c1": f})() for f in forms]
    shares = [rng.getrandbits(100), -rng.getrandbits(90)]
    want = [[f if s >= 0 else reduce_form(neg(f)) for f in
             (nupow(c, abs(s)) for c in forms)] for s in shares]
    got, errors = [[], []], []

    def work(i):
        try:
            for _ in range(3):
                got[i].append(eng.part_decrypt_batch(shares[i], cts))
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i in range(2):
        assert len(got[i]) == 3
        for out in got[i]:
            assert _tuples(out) == _tuples(want[i])


@pytest.mark.cuda
def test_nucomp_ladder_runs_on_card(cuda_device):
    _, eng, ncg, forms, rng = _card(cuda_device, lanes=128, seed=54, use_nucomp=True)
    e = _exponent(rng, 60)
    sched = wnaf_digits(e, W)
    bf = bform_from_forms(forms, ncg.L, cuda_device)
    bank = make_wnaf_bank(ncg, bf, W)
    ident = identity_bform2(ncg, len(forms))
    got = wnaf_segment(ncg, bank, ident, sched)
    (lg,) = ncg.compose_graphs.ladders.values()
    assert any(k[0] == "lehmer_euclid" for k in lg.launches[0].per_replay)
    # against the default tail's steps, eager
    for x, y in zip(got, LadderSteps(eng.cg, bank, ident).run(bank, ident, sched)):
        assert torch.equal(x, y)
    assert _tuples(bform_to_forms(got)) == _tuples(nupow(f, e) for f in forms)
