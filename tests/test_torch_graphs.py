"""compose2 as one device program: the route that the CUDA graph of
ops/graphs.py captures, held on the CPU against the JAX package's
CG.compose2 (under jax.jit), and (on a CUDA card only) graph replays
against eager compose2.

* rl.redc_pow16 runs its Montgomery step on every lane, with no host test
  for an empty mask; on a batch whose lanes all fit 8 limbs the rare
  width-Lh pipeline is empty (its REDCs run on no active lane), and on
  the two-tier 731-bit case of test_torch_forms2 both pipelines are live.
* compose2, with the kernels' plain versions as opaque calls, reads no
  tensor value on the host: every tensor it makes is a
  subclass whose __bool__ / item / tolist / numpy / boolean indexing
  raise, so a sync that a capture on the card would refuse shows here.
  On the card's route (no shared 2-adic inverse) it calls K5m 7 times,
  K5d 4 times, K4 4 times, K6a 4 times, K6b, K6c, K6d and K6e once each
  and limb.inv_pow2 never, and gives the JAX package's forms.
* ComposeGraph refuses a CPU device; the launch keys a capture records
  are not counted until a replay counts them.

Tolerance: exact equality of the reduced forms, which are unique.
"""

import collections
import contextlib
import random
import threading

import jax
import numpy as np
import pytest
import torch

from cofhe_tpu.core.qfi import compose, identity_form, nupow
from cofhe_tpu.ops.forms import bform_from_forms as jbform_from_forms
from cofhe_tpu_torch.ops import cuda_group
from cofhe_tpu_torch.ops.forms import BForm, bform_from_forms, bform_to_forms
from cofhe_tpu_torch.ops.forms2 import CG
from cofhe_tpu_torch.ops.graphs import ComposeGraph
from test_torch_forms2 import _cgs, _jax_out, _tuples

torch.set_num_threads(1)


def _distinct_pairs(hsm, B, seed):
    """B pairs of distinct powers of h (no identity, no self-compose, no
    inverse pair): d1 = gcd(a2, a1) fits 8 limbs on every lane."""
    rng = random.Random(seed)
    pool = [nupow(hsm.h, rng.randrange(1, 1 << 60)) for _ in range(2 * B)]
    return pool[:B], pool[B:]


class _Redc:
    """Records the `active` mask of every CG._redc_mod call."""

    def __init__(self, monkeypatch):
        self.masks = []
        orig = CG._redc_mod

        def spy(cg, x, d, active, inv):
            self.masks.append(active.clone())
            return orig(cg, x, d, active, inv)

        monkeypatch.setattr(CG, "_redc_mod", spy)


def test_compose2_matches_jax_when_every_lane_fits_8_limbs(toy_hsm, monkeypatch):
    jcg, pcg, L = _cgs(toy_hsm)
    f1, f2 = _distinct_pairs(toy_hsm, 64, 5)
    want = _jax_out(jax.jit(jcg.compose2), jbform_from_forms(f1, L),
                    jbform_from_forms(f2, L))
    assert want == _tuples(compose(a, b) for a, b in zip(f1, f2))
    p1, p2 = bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu")
    redc = _Redc(monkeypatch)
    got = pcg.compose2(p1, p2)
    assert _tuples(bform_to_forms(got)) == want
    # four REDCs: two width-8, then two on the rare lanes, of which there
    # are none here
    assert len(redc.masks) == 4
    assert bool(redc.masks[0].all()) and not bool(redc.masks[2].any())
    # nudupl2 too, and a CPU compose2 never builds a graph
    assert _tuples(bform_to_forms(pcg.nudupl2(p1))) == _tuples(compose(f, f) for f in f1)
    assert pcg.compose_graphs.graphs == {}


def test_compose2_two_tier_both_redc_pipelines_match_jax():
    """The 731-bit case of test_torch_forms2: the narrow and full-width
    first xgcds and both REDC pipelines are live."""
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


# ------------------------------------------------------- no host reads


class _NoSync(torch.Tensor):
    """A tensor whose values the host may not read (the reads a CUDA graph
    capture refuses: a sync or a data-dependent shape)."""

    BANNED = {"__bool__", "__int__", "__float__", "__index__", "item", "tolist",
              "numpy", "cpu", "nonzero", "masked_select", "unique", "argwhere"}

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in cls.BANNED:
            raise AssertionError(f"compose2 read a tensor on the host: {name}")
        if name == "__getitem__" and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in (args[1] if isinstance(args[1], tuple) else (args[1],))):
            raise AssertionError("compose2 indexed with a boolean mask")
        if name == "where" and len(args) + len(kwargs or {}) == 1:
            raise AssertionError("compose2 called torch.where(cond)")
        return super().__torch_function__(func, types, args, kwargs or {})


def _plain(x):
    return x.as_subclass(torch.Tensor) if isinstance(x, torch.Tensor) else x


def _guarded(x):
    if isinstance(x, tuple):
        return type(x)(*(_guarded(y) for y in x)) if hasattr(x, "_fields") \
            else tuple(_guarded(y) for y in x)
    return x.as_subclass(_NoSync) if isinstance(x, torch.Tensor) else x


@contextlib.contextmanager
def _opaque_kernels(monkeypatch, calls=None):
    """The kernel dispatchers (cuda_group.DISPATCH) run their plain versions
    on plain tensors (on the card they are single launches); `calls` counts
    the dispatcher calls made outside another one (`calls["inside"]` > 0
    while one runs)."""
    calls = collections.Counter() if calls is None else calls
    for name in (d.name for d in cuda_group.DISPATCH.values()):
        orig = getattr(cuda_group, name + "_plain")

        def call(*args, _orig=orig, _name=name, **kw):
            if not calls["inside"]:
                calls[_name] += 1
            calls["inside"] += 1
            try:
                return _guarded(_orig(*(_plain(a) for a in args),
                                      **{k: _plain(v) for k, v in kw.items()}))
            finally:
                calls["inside"] -= 1

        monkeypatch.setattr(cuda_group, name, call)
    yield calls


def test_compose2_reads_nothing_on_the_host(toy_hsm, monkeypatch):
    _, pcg, L = _cgs(toy_hsm)
    rng = random.Random(7)
    pool = [nupow(toy_hsm.h, rng.randrange(1, 1 << 60)) for _ in range(8)]
    f1 = [pool[rng.randrange(8)] for _ in range(16)]
    f2 = [pool[rng.randrange(8)] for _ in range(16)]
    f1[0] = identity_form(toy_hsm.Delta)
    f1[1] = f2[1]  # d1 = a: the rare REDC pipeline is live
    f1[2] = toy_hsm.power_of_f(3)
    p1, p2 = bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu")
    want = _tuples(bform_to_forms(pcg.compose2(p1, p2)))
    with _opaque_kernels(monkeypatch):
        out = pcg.compose2_eager(_guarded(p1), _guarded(p2))
    # the guard is live: the host reads it bans raise
    with pytest.raises(AssertionError, match="host"):
        bool(_guarded(p1).a.any())
    with pytest.raises(AssertionError, match="boolean mask"):
        _guarded(p1).a[_guarded(p1).b_sign > 0]
    assert isinstance(out.a, _NoSync)
    assert _tuples(bform_to_forms(BForm(*(_plain(x) for x in out)))) == want


def test_compose2_card_route_launches_the_kernels_and_no_inverse(toy_hsm, monkeypatch):
    """The card's call plan, on the CPU: with the route compose2 takes for
    a CUDA tensor (cuda_group.plain_route false: no shared 2-adic inverse)
    and every kernel an opaque call to its plain version, one compose2
    calls K5m 7 times, K5d 4 times, K4 4 times, K6a 4 times and K6b, K6c,
    K6d and K6e once each, calls limb.inv_pow2
    never outside a kernel, reads nothing on the host and gives the JAX
    package's reduced forms."""
    jcg, pcg, L = _cgs(toy_hsm)
    rng = random.Random(7)
    pool = [nupow(toy_hsm.h, rng.randrange(1, 1 << 60)) for _ in range(8)]
    f1 = [pool[rng.randrange(8)] for _ in range(16)]
    f2 = [pool[rng.randrange(8)] for _ in range(16)]
    f1[0] = identity_form(toy_hsm.Delta)
    f1[1] = f2[1]  # d1 = a: the rare REDC pipeline is live
    f1[2] = toy_hsm.power_of_f(3)
    want = _jax_out(jax.jit(jcg.compose2), jbform_from_forms(f1, L),
                    jbform_from_forms(f2, L))
    inverses = []
    orig_inv = cuda_group.lb.inv_pow2
    monkeypatch.setattr(cuda_group, "plain_route", lambda t: False)
    with _opaque_kernels(monkeypatch) as calls:
        def inv_spy(*a, **k):
            if not calls["inside"]:
                inverses.append(a[0].shape)
            return orig_inv(*a, **k)

        monkeypatch.setattr(cuda_group.lb, "inv_pow2", inv_spy)
        out = pcg.compose2_eager(_guarded(bform_from_forms(f1, L, "cpu")),
                                 _guarded(bform_from_forms(f2, L, "cpu")))
    assert isinstance(out.a, _NoSync)
    assert _tuples(bform_to_forms(BForm(*(_plain(x) for x in out)))) == want
    assert inverses == []
    assert (calls["mag_mul"], calls["mag_divexact_odd"], calls["redc_mod"]) == (7, 4, 4)
    assert (calls["canon_sm"], calls["compose_prologue"]) == (4, 1)
    assert calls["gcd_bridge"] == calls["gcd2_merge"] == calls["c3_operands"] == 1
    assert calls["reduce2_grouped_loop"] == calls["reduce_exact"] == calls["mod_topdown"] == 1


# --------------------------------------------------- graphs and launches


def test_compose_graph_refuses_a_cpu_device(toy_hsm):
    _, pcg, L = _cgs(toy_hsm)
    f1, f2 = _distinct_pairs(toy_hsm, 4, 1)
    with pytest.raises(ValueError, match="CUDA graphs"):
        ComposeGraph(pcg, bform_from_forms(f1, L, "cpu"), bform_from_forms(f2, L, "cpu"))


def test_captured_launches_are_counted_by_replays(monkeypatch):
    """cuda_group._launch records this thread's launches into the graph
    being captured (another thread's are not) and counts them only for
    the graph's replays, which LAUNCHES adds when read."""
    calls = []
    monkeypatch.setattr(cuda_group, "build", lambda: {
        n: (lambda *a, _n=n: calls.append(_n) or 0) for n in cuda_group.KERNELS})
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    ref = torch.zeros(1)
    key = ("reduce_exact", 24, 0, 8)
    before = dict(cuda_group.LAUNCHES)
    before_key = cuda_group.LAUNCHES_BY_KEY.get(key, 0)
    keys = []
    with cuda_group.capturing_launches(keys):
        cuda_group._launch(key, ref)
        other = threading.Thread(target=cuda_group._launch, args=(key, ref))
        other.start()
        other.join()
    assert keys == [key] and calls == ["reduce_exact"] * 2
    # only the other thread's launch was counted
    assert cuda_group.LAUNCHES["reduce_exact"] == before["reduce_exact"] + 1
    owner = type("Graph", (), {})()  # the record's graph, as a ComposeGraph is
    graph = cuda_group.graph_launches(owner, keys)
    for _ in range(3):  # three replays, as ComposeGraph.run counts them
        graph.replays += 1
    assert cuda_group.LAUNCHES["reduce_exact"] == before["reduce_exact"] + 4
    assert cuda_group.LAUNCHES_BY_KEY[key] == before_key + 4
    assert {k: v for k, v in cuda_group.LAUNCHES.items() if k != "reduce_exact"} == \
        {k: v for k, v in before.items() if k != "reduce_exact"}


# --------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the Hopper kernels")
    return torch.device("cuda")


def _card_cgs(device):
    from conftest import toy_prime
    from cofhe_tpu_torch.core.cl_hsm2k import CLHSM2k
    from cofhe_tpu_torch.ops.engine import TorchEngine

    hsm = CLHSM2k(128, 32, p=toy_prime(100))
    ecg = TorchEngine(hsm, device).cg
    ecg.compose2 = ecg.compose2_eager  # the body every capture runs
    return hsm, TorchEngine(hsm, device).cg, ecg


@pytest.mark.cuda
def test_graph_replay_matches_eager_on_card(cuda_device):
    """compose2 and nudupl2 at 128 lanes by graph replay equal the eager
    compose2 bit for bit, also when an output is fed straight back in."""
    hsm, gcg, ecg = _card_cgs(cuda_device)
    rng = random.Random(3)
    pool = [nupow(hsm.h, rng.randrange(1, 1 << 60)) for _ in range(16)]
    f1 = [pool[rng.randrange(16)] for _ in range(128)]
    f2 = [pool[rng.randrange(16)] for _ in range(128)]
    f1[0], f1[1], f1[2] = identity_form(hsm.Delta), f2[1], hsm.power_of_f(5)
    b1 = bform_from_forms(f1, gcg.L, cuda_device)
    b2 = bform_from_forms(f2, gcg.L, cuda_device)
    g, e = gcg.compose2(b1, b2), ecg.compose2(b1, b2)
    for _ in range(2):  # replays on the previous replay's output
        g, e = gcg.compose2(g, b2), ecg.compose2(e, b2)
        gd, ed = gcg.nudupl2(g), ecg.nudupl2(e)
        for x, y in zip(g + gd, e + ed):
            assert torch.equal(x, y)
    assert len(gcg.compose_graphs.graphs) == 1 and not ecg.compose_graphs.graphs
    want = [compose(compose(compose(a, b), b), b) for a, b in zip(f1, f2)]
    assert _tuples(bform_to_forms(gcg.compose2(gcg.compose2(
        gcg.compose2(b1, b2), b2), b2))) == _tuples(want)


@pytest.mark.cuda
def test_replays_count_the_captured_launches_on_card(cuda_device):
    hsm, gcg, _ = _card_cgs(cuda_device)
    rng = random.Random(4)
    f = [nupow(hsm.h, rng.randrange(1, 1 << 60)) for _ in range(128)]
    b = bform_from_forms(f, gcg.L, cuda_device)
    gcg.nudupl2(b)  # warm-up, capture, first replay
    (graph,) = gcg.compose_graphs.graphs.values()
    kinds = collections.Counter(k[0] for k in graph.keys)
    # two first-gcd passes where the narrow width is below L, then W=8, Lh;
    # seven products, four exact quotients, four REDCs, four signed sums,
    # the prologue, the gcd bridge and merge and c3's operands
    assert kinds == {"xgcd_coeff_g": 4 if gcg.Lxn < gcg.L else 3, "mod_topdown": 1,
                     "reduce2_grouped": 1, "reduce_exact": 1, "mag_mul": 7,
                     "divexact_odd": 4, "redc_mod": 4, "canon_sm": 4,
                     "compose_prologue": 1, "gcd_bridge": 1, "gcd2_merge": 1,
                     "c3_operands": 1}
    for _ in range(3):
        before = dict(cuda_group.LAUNCHES)
        by_key = dict(cuda_group.LAUNCHES_BY_KEY)
        gcg.nudupl2(b)
        assert {k: cuda_group.LAUNCHES[k] - before[k] for k in before} == \
            {k: kinds.get(k, 0) for k in before}
        for k, n in collections.Counter(graph.keys).items():
            assert cuda_group.LAUNCHES_BY_KEY[k] - by_key.get(k, 0) == n
    assert graph.replays == 4 and np.isfinite(graph.capture_s)
