"""compose2 as a DAG (ops/forms2.py `_Dag`, captured by ops/graphs.py).

The oracle is the JAX package's pure-Python class group
(cofhe_tpu.core.qfi, cofhe_tpu.core.cl_hsm2k); the port's CPU plain route
is held to it as well, as a second comparison.

On the CPU: the fork helper runs each chain in line, in order, and hands
back its result; one compose2 passes 3 fork sites, with a single-tier
(Lxn = L) and a two-tier (Lxn < L, every configuration of the benchmark)
first gcd, and gives the oracle's forms; the ladder's `graphs.ladder`
span carries the count as `branches` while tracing is on.

On a CUDA card only: the compose2 graph replayed 200 times back to back at
512 and 16384 lanes on changing inputs, the ladder's S and SC graphs 200
times at 512 lanes, and eager forked compose2 calls with the allocator
under churn, every output bit for bit against the oracle's forms; the
graphs record the fork sites and their spans carry them.

Fixtures: the repository's toy parameters (k = 32) at a 100-bit prime
(single-tier) and a 731-bit prime (two-tier); lanes: powers of h, h, f,
powers of f, the identity and self-composes. Tolerance: exact equality of
the reduced forms, which are unique.
"""

import random

import pytest
import torch

from conftest import toy_prime
from cofhe_tpu.core.cl_hsm2k import CLHSM2k
from cofhe_tpu.core.qfi import compose, identity_form, neg, nudupl, nupow
from cofhe_tpu_torch.ops import forms2, graphs
from cofhe_tpu_torch.ops.engine import TorchEngine
from cofhe_tpu_torch.ops.forms import BForm, bform_from_forms, bform_to_forms
from cofhe_tpu_torch.ops.graphs import LadderSteps
from cofhe_tpu_torch.ops.nupow2 import identity_bform2, make_wnaf_bank, wnaf_digits
from cofhe_tpu_torch.utils import trace

torch.set_num_threads(1)

W = 5
POOL = 128  # distinct operand pairs; a batch gathers its lanes from them


_HSM: dict = {}


def _hsm(bits: int) -> CLHSM2k:
    if bits not in _HSM:
        _HSM[bits] = CLHSM2k(128, 32, p=toy_prime(bits))
    return _HSM[bits]


def _tuples(forms):
    return [(f.a, f.b, f.c) for f in forms]


def _operands(hsm, n: int, seed: int):
    """n pairs of lanes: powers of h, the identity on either side, a
    self-compose (d1 = a: the rare pipeline), powers of f, h with h^2."""
    rng = random.Random(seed)
    pool = [nupow(hsm.h, rng.randrange(1, 1 << 60)) for _ in range(16)]
    f1 = [pool[rng.randrange(16)] for _ in range(n)]
    f2 = [pool[rng.randrange(16)] for _ in range(n)]
    f1[0] = identity_form(hsm.Delta)
    f2[1] = identity_form(hsm.Delta)
    f1[2] = f2[2]
    f1[3], f2[3] = hsm.power_of_f(5), hsm.power_of_f(9)
    f1[4], f2[4] = hsm.power_of_f(3), pool[0]
    f1[5], f2[5] = hsm.h, nupow(hsm.h, 2)
    return f1, f2


# ------------------------------------------------------------ the CPU


def test_fork_runs_each_chain_in_line_on_the_cpu():
    dag = forms2._Dag(torch.zeros(1))
    assert dag.sides is None  # no side stream on the CPU
    order = []

    def chain(x, y):
        order.append("chain")
        return x + y, x * y

    b = dag.fork(chain, torch.tensor(2), torch.tensor(3))
    order.append("after")
    out = b.join()
    assert order == ["chain", "after"] and dag.forks == 1
    assert int(out[0]) == 5 and int(out[1]) == 6
    assert b.join() is out


@pytest.mark.parametrize("bits,tier", [(100, "single"), (731, "two")])
def test_one_compose2_passes_its_fork_sites_on_the_cpu(bits, tier):
    hsm = _hsm(bits)
    cg = TorchEngine(hsm, "cpu").cg
    assert (cg.Lxn < cg.L) == (tier == "two")
    assert cg.branches == 0  # no compose2 yet
    f1, f2 = _operands(hsm, 12, bits)
    got = cg.compose2(bform_from_forms(f1, cg.L, "cpu"), bform_from_forms(f2, cg.L, "cpu"))
    assert _tuples(bform_to_forms(got)) == _tuples(compose(a, b) for a, b in zip(f1, f2))
    assert cg.branches == 3
    # nudupl2 passes the same sites
    got = cg.nudupl2(bform_from_forms(f1, cg.L, "cpu"))
    assert _tuples(bform_to_forms(got)) == _tuples(nudupl(f) for f in f1)
    assert cg.branches == 3


def test_ladder_span_carries_the_fork_sites_on_the_cpu():
    hsm = _hsm(731)
    cg = TorchEngine(hsm, "cpu").cg
    f1, _ = _operands(hsm, 6, 7)
    base = bform_from_forms(f1, cg.L, "cpu")
    bank = make_wnaf_bank(cg, base, W)
    steps = LadderSteps(cg, bank, base)
    ident = identity_bform2(cg, len(f1))
    e = (1 << 11) | 0x2B5
    trace.clear()
    try:
        with trace.enabled():
            got = steps.run(bank, ident, wnaf_digits(e, W))
        (rec,) = [r for r in trace.records() if r.name == "graphs.ladder"]
    finally:
        trace.clear()
    assert rec.attrs == {"lanes": len(f1), "steps": len(wnaf_digits(e, W)), "branches": 3}
    assert cg.branches == 3
    assert _tuples(bform_to_forms(got)) == _tuples(nupow(f, e) for f in f1)


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the Hopper kernels")
    return torch.device("cuda")


def _equal(got: BForm, want: BForm) -> bool:
    return all(torch.equal(x, y) for x, y in zip(got, want))


def _pool(hsm, cpu_cg, seed: int):
    """POOL operand pairs on the CPU and the oracle's compositions; the
    plain route's compose2 gives them too, limb for limb."""
    f1, f2 = _operands(hsm, POOL, seed)
    p1 = bform_from_forms(f1, cpu_cg.L, "cpu")
    p2 = bform_from_forms(f2, cpu_cg.L, "cpu")
    want = bform_from_forms([compose(a, b) for a, b in zip(f1, f2)], cpu_cg.L, "cpu")
    assert _equal(cpu_cg.compose2(p1, p2), want)
    return p1, p2, want


def _gather(F: BForm, idx) -> BForm:
    return BForm(*(x[idx] for x in F))


def _lanes(B: int, i: int, dev):
    """Replay i's lanes: each lane another pool pair than at replay i - 1."""
    return (torch.arange(B, device=dev) * 7 + 13 * i + i * i) % POOL


@pytest.mark.cuda
@pytest.mark.parametrize("B", [512, 16384])
def test_compose_graph_replays_back_to_back_match_the_plain_route_on_card(cuda_device, B):
    hsm = _hsm(731)
    cpu_cg = TorchEngine(hsm, "cpu").cg
    cg = TorchEngine(hsm, cuda_device).cg
    p1, p2, want = _pool(hsm, cpu_cg, B)
    d1, d2, dw = (BForm(*(x.to(cuda_device) for x in F)) for F in (p1, p2, want))
    bad = torch.zeros((), dtype=torch.int64, device=cuda_device)
    trace.clear()
    try:
        with trace.enabled():
            for i in range(200):
                idx = _lanes(B, i, cuda_device)
                out = cg.compose2(_gather(d1, idx), _gather(d2, idx))
                for x, y in zip(out, _gather(dw, idx)):
                    bad += (x != y).sum()
        spans = [r for r in trace.records() if r.name == "graphs.replay"]
    finally:
        trace.clear()
    assert int(bad) == 0
    (g,) = cg.compose_graphs.graphs.values()
    assert g.branches == cg.branches == 3 and g.replays == 200
    # queued on the CG's stream, its engine's, though called from the default stream
    sid = cg.compose_graphs.stream.cuda_stream
    assert len(spans) == 200 and all(r.attrs == {"lanes": B, "branches": 3, "stream": sid}
                                     for r in spans)
    # the DAG's streams: the device's two side streams, neither the caller's
    _, *sides = graphs.side_streams(d1.a.device)
    assert {s.priority for s in sides} == {graphs.SIDE_PRIORITY}
    assert len({s.cuda_stream for s in sides}
               | {torch.cuda.current_stream().cuda_stream}) == 3


def _tiled_equal(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Whether the card's lanes (copies of the CPU's lanes, one after the
    other, along dimension `dim`) all equal the CPU's."""
    dim = 0 if got.dim() == want.dim() and got.shape[0] != want.shape[0] else 1
    n = got.shape[dim] // want.shape[dim]
    return all(torch.equal(part.cpu(), want) for part in got.chunk(n, dim))


@pytest.mark.cuda
def test_ladder_step_graphs_back_to_back_match_the_plain_route_on_card(cuda_device):
    """200 ladder digits at 512 lanes, one call a digit (S, or SC with a
    bank row or its inverse), each output against the oracle's square and
    compose with base^|d| or its inverse, and LadderSteps on the CPU
    against the same. The 512 lanes are four copies of POOL bases, so the
    oracle and the CPU step POOL."""
    hsm = _hsm(731)
    cpu_cg = TorchEngine(hsm, "cpu").cg
    cg = TorchEngine(hsm, cuda_device).cg
    rng = random.Random(61)
    f1, _ = _operands(hsm, POOL, 61)
    base = bform_from_forms(f1, cg.L, "cpu")
    cpu_bank = make_wnaf_bank(cpu_cg, base, W)
    bank = make_wnaf_bank(cg, bform_from_forms(f1 * 4, cg.L, cuda_device), W)
    for x, y in zip(bank, cpu_bank):  # (S, 512, ...) against (S, 128, ...)
        assert _tiled_equal(x, y)
    sched = []
    while len(sched) < 200:
        sched += wnaf_digits(rng.getrandbits(64) | 1 << 63, W)
    sched = sched[:200]
    assert any(d < 0 for d in sched) and any(d > 0 for d in sched)
    r = identity_bform2(cg, 4 * POOL)
    outs = []
    trace.clear()
    try:
        with trace.enabled():
            for d in sched:
                r = cg.compose_graphs.run_ladder(bank, r, [d])
                outs.append(r)
        spans = [x for x in trace.records() if x.name == "graphs.ladder"]
    finally:
        trace.clear()
    odd = {d: [nupow(f, d) for f in f1] for d in range(1, 1 << (W - 1), 2)}
    steps = LadderSteps(cpu_cg, cpu_bank, base)
    r_cpu = identity_bform2(cpu_cg, POOL)
    r_or = [identity_form(hsm.Delta)] * POOL
    for d, got in zip(sched, outs):
        r_or = [nudupl(f) for f in r_or]
        if d:
            r_or = [compose(f, t if d > 0 else neg(t)) for f, t in zip(r_or, odd[abs(d)])]
        want = bform_from_forms(r_or, cg.L, "cpu")
        for x, y in zip(got, want):
            assert _tiled_equal(x, y)
        r_cpu = steps.run(cpu_bank, r_cpu, [d])
        assert _equal(r_cpu, want)
    (lg,) = cg.compose_graphs.ladders.values()
    assert cg.branches == 3 and lg.steps == 200
    assert len(spans) == 200
    sid = cg.compose_graphs.stream.cuda_stream  # no other stream's ladder runs
    assert all(x.attrs == {"lanes": 4 * POOL, "steps": 1, "branches": 3, "stream": sid,
                           "beside": 0} for x in spans)


@pytest.mark.cuda
def test_eager_forked_compose2_under_allocator_churn_matches_on_card(cuda_device):
    """Eager compose2 (no graph) at 512 lanes, 40 calls back to back; between
    calls fresh tensors of compose2's sizes are made, written and freed on
    the caller's stream, so a block that the allocator handed out too early
    would show as a wrong limb."""
    hsm = _hsm(731)
    cpu_cg = TorchEngine(hsm, "cpu").cg
    cg = forms2.CG(cpu_cg.disc_bits, cpu_cg.delta4.to(cuda_device),
                   BForm(*(x.to(cuda_device) for x in cpu_cg.h)),
                   BForm(*(x.to(cuda_device) for x in cpu_cg.h2)))
    p1, p2, want = _pool(hsm, cpu_cg, 512)
    d1, d2, dw = (BForm(*(x.to(cuda_device) for x in F)) for F in (p1, p2, want))
    gen = torch.Generator(device="cpu").manual_seed(5)
    bad = torch.zeros((), dtype=torch.int64, device=cuda_device)
    for i in range(40):
        idx = _lanes(512, i, cuda_device)
        out = cg.compose2_eager(_gather(d1, idx), _gather(d2, idx))
        for _ in range(8):
            L = int(torch.randint(1, 4 * cg.Lm, (1,), generator=gen))
            junk = torch.empty((512, L), dtype=torch.int32, device=cuda_device)
            junk.fill_(-1)
            del junk
        for x, y in zip(out, _gather(dw, idx)):
            bad += (x != y).sum()
        del out
    assert int(bad) == 0
    assert cg.branches == 3 and not cg.compose_graphs.graphs
