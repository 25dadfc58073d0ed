"""One stream an engine (ops/engine.py, ops/graphs.py `owned_stream`,
`LadderRegistry`).

On the CPU: an engine has no stream and its ops give the host oracle's
forms; two engines' part-decryptions from two threads at once agree with
the oracle; the ladder registry's `beside` count on stub events; the
device's free list of engines' streams, with the driver and torch's
stream class stubbed: no two live owners share a stream, and a collected
owner's stream goes to the next.

On a CUDA card only: 40 engines on one device, each with a captured
compose2, leave every engine's stream distinct from the others', from
compose2's side streams and from the default streams, non-blocking, of
priority 0; two engines' part-decryptions of one ct(8x64) with different
shares, from two threads at once, equal the serial run and the host oracle
bit for bit, the second ladder's span reports `beside` >= 1 and each
ladder step launches the kernels of the parent's call plan.

Toy fixtures (k=32, 100-bit p). Tolerance: exact equality of the reduced
forms.
"""

import collections
import ctypes
import gc
import random
import threading

import pytest
import torch

from cofhe_tpu.core.qfi import compose, neg, nupow, reduce_form
from cofhe_tpu_torch.core.cl_hsm2k import CLHSM2k
from cofhe_tpu_torch.ops import graphs
from cofhe_tpu_torch.ops.engine import TorchEngine
from cofhe_tpu_torch.utils import trace

torch.set_num_threads(1)


class _Ct:
    def __init__(self, c1, c2=None):
        self.c1, self.c2 = c1, c2


def _hsm():
    from conftest import toy_prime

    return CLHSM2k(128, 32, p=toy_prime(100))


def _tuples(forms):
    return [tuple(f) for f in forms]


def _part_decrypt_oracle(forms, share: int):
    out = [nupow(f, abs(share)) for f in forms]
    return out if share >= 0 else [reduce_form(neg(f)) for f in out]


def _forms(hsm, n: int, seed: int):
    rng = random.Random(seed)
    pool = [nupow(hsm.h, rng.randrange(1, 1 << 60)) for _ in range(8)]
    return [pool[rng.randrange(8)] for _ in range(n - 1)] + [hsm.f]


# ------------------------------------------------------------------ the CPU


def test_cpu_engine_has_no_stream_and_its_ops_match_the_oracle():
    hsm = _hsm()
    eng = TorchEngine(hsm, "cpu")
    assert eng.stream is None and eng.cg.compose_graphs.stream is None
    f1, f2 = _forms(hsm, 6, 1), _forms(hsm, 6, 2)
    got = eng.compose_forms_batch(f1, f2)
    assert _tuples(got) == _tuples(compose(a, b) for a, b in zip(f1, f2))
    cts = [_Ct(a, b) for a, b in zip(f1, f2)]
    added = eng.add_batch(cts, cts)
    assert _tuples(c.c1 for c in added) == _tuples(compose(a, a) for a in f1)
    assert _tuples(c.c2 for c in added) == _tuples(compose(b, b) for b in f2)
    share = -((1 << 40) | 0x5A5A5)
    assert _tuples(eng.part_decrypt_batch(share, cts)) == \
        _tuples(_part_decrypt_oracle(f1, share))


def test_two_cpu_engines_part_decrypt_from_two_threads():
    hsm = _hsm()
    engines = [TorchEngine(hsm, "cpu") for _ in range(2)]
    forms = _forms(hsm, 5, 3)
    cts = [_Ct(f) for f in forms]
    shares = [(1 << 36) | 0x3C3C3, -((1 << 33) | 0x12345)]
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def work(i):
        try:
            start.wait()
            got[i] = engines[i].part_decrypt_batch(shares[i], cts)
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i in range(2):
        assert _tuples(got[i]) == _tuples(_part_decrypt_oracle(forms, shares[i]))


class _Event:
    """A stub of a CUDA event: done or not, as its query() says."""

    def __init__(self, done: bool):
        self.done = done

    def query(self) -> bool:
        return self.done


def test_ladder_registry_counts_other_streams_ladders_still_running():
    reg = graphs.LadderRegistry()
    assert reg.begin(1) == 0          # the first ladder on the device
    assert reg.begin(2) == 1          # stream 1's ladder is being enqueued
    first = _Event(False)
    reg.end(1, first)                 # enqueued, not done on the card
    assert reg.begin(3) == 2          # stream 1 running, stream 2 enqueuing
    reg.end(2, _Event(True))
    reg.end(3, _Event(True))
    assert reg.begin(2) == 1          # stream 1 still running; 3 done
    first.done = True
    reg.end(2, _Event(False))
    assert reg.begin(1) == 1          # its own stream does not count
    reg.end(1, None)                  # a ladder that raised: dropped
    assert reg.begin(4) == 1          # only stream 2's


def test_owned_streams_are_distinct_while_their_owners_live(monkeypatch):
    made = []

    def driver_stream(dev):
        made.append(len(made) + 1)
        return made[-1]

    class Stub:
        def __init__(self, handle, device):
            self.cuda_stream, self.device = handle, device

    monkeypatch.setattr(graphs, "_driver_stream", driver_stream)
    monkeypatch.setattr(torch.cuda, "ExternalStream", Stub)
    dev = torch.device("cuda", 7)  # no card: a key of the free list only

    class Owner:
        pass

    try:
        owners = [Owner() for _ in range(40)]
        streams = [graphs.owned_stream(o, dev) for o in owners]
        assert len({s.cuda_stream for s in streams}) == 40 and made == list(range(1, 41))
        assert all(s.device == dev for s in streams)
        gone = {streams[3].cuda_stream, streams[17].cuda_stream}
        del owners[17], owners[3]
        gc.collect()
        fresh = [Owner(), Owner()]
        again = [graphs.owned_stream(o, dev) for o in fresh]
        assert {s.cuda_stream for s in again} == gone and len(made) == 40
        live = {s.cuda_stream for s in streams} - gone
        assert not live & {s.cuda_stream for s in again}
        assert graphs.owned_stream(owners[0], dev).cuda_stream == 41
    finally:
        owners = fresh = streams = again = None
        gc.collect()
        graphs._FREE_STREAMS.pop(dev, None)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engines' streams and the Hopper kernels")
    return torch.device("cuda", torch.cuda.current_device())


def _stream_flags(stream) -> int:
    cu = ctypes.CDLL("libcuda.so.1")
    flags = ctypes.c_uint()
    assert cu.cuStreamGetFlags(ctypes.c_void_p(stream.cuda_stream), ctypes.byref(flags)) == 0
    return flags.value


@pytest.mark.cuda
def test_forty_engines_on_one_device_have_streams_of_their_own_on_card(cuda_device):
    hsm = _hsm()
    f1, f2 = _forms(hsm, 2, 4), _forms(hsm, 2, 5)
    want = _tuples(compose(a, b) for a, b in zip(f1, f2))
    engines = []
    for _ in range(40):
        eng = TorchEngine(hsm, cuda_device)
        # a captured compose2 a CG: each capture draws a stream of torch's pool
        assert _tuples(eng.compose_forms_batch(f1, f2)) == want
        engines.append(eng)
    ours = {e.stream.cuda_stream for e in engines}
    assert len(ours) == 40
    _, *sides = graphs.side_streams(cuda_device)
    assert not ours & {s.cuda_stream for s in sides}
    defaults = {torch.cuda.default_stream(cuda_device).cuda_stream, 0, 1, 2}
    assert not ours & defaults
    assert all(e.cg.compose_graphs.stream is e.stream for e in engines)
    assert all(e.stream.priority == 0 for e in engines)
    assert all(_stream_flags(e.stream) & 1 for e in engines)  # CU_STREAM_NON_BLOCKING


def _kinds(rec) -> dict:
    kinds = collections.Counter()
    for key, n in rec.per_replay.items():
        kinds[key[0]] += n
    return dict(kinds)


@pytest.mark.cuda
def test_two_engines_part_decrypt_beside_each_other_on_card(cuda_device):
    hsm = _hsm()
    forms = _forms(hsm, 512, 6)  # ct(8x64): 512 lanes
    cts = [_Ct(f) for f in forms]
    rng = random.Random(7)
    shares = [rng.getrandbits(400) | 1 << 399, -(rng.getrandbits(380) | 1 << 379)]
    engines = [TorchEngine(hsm, cuda_device) for _ in range(2)]
    serial = [engines[i].part_decrypt_batch(shares[i], cts) for i in range(2)]
    got, errors = [None, None], []
    start = threading.Barrier(2)

    def work(i):
        try:
            start.wait()
            got[i] = engines[i].part_decrypt_batch(shares[i], cts)
        except BaseException as e:  # reported below
            errors.append(e)

    trace.clear()
    try:
        with trace.enabled():
            threads = [threading.Thread(target=work, args=(i,)) for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        ladders = [r for r in trace.records() if r.name == "graphs.ladder"]
        replays = [r for r in trace.records() if r.name == "graphs.replay"]
    finally:
        trace.clear()
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i in range(2):
        assert _tuples(got[i]) == _tuples(serial[i])
        assert _tuples(got[i][:32]) == _tuples(_part_decrypt_oracle(forms[:32], shares[i]))
        assert _tuples(got[i][-1:]) == _tuples(_part_decrypt_oracle(forms[-1:], shares[i]))
    ours = {e.stream.cuda_stream for e in engines}
    assert len(ladders) == 2 and {r.attrs["stream"] for r in ladders} == ours
    assert max(r.attrs["beside"] for r in ladders) >= 1
    assert all(r.attrs["lanes"] == 512 for r in ladders)
    assert replays and {r.attrs["stream"] for r in replays} == ours
    # each step graph launches the parent's call plan: S one compose2's
    # kernels, SC two
    cg = engines[0].cg
    plan = {"xgcd_coeff_g": 4 if cg.Lxn < cg.L else 3, "mod_topdown": 1,
            "reduce2_grouped": 1, "reduce_exact": 1, "mag_mul": 7, "divexact_odd": 4,
            "redc_mod": 4, "canon_sm": 4, "compose_prologue": 1, "gcd_bridge": 1,
            "gcd2_merge": 1, "c3_operands": 1}
    for eng in engines:
        (lg,) = eng.cg.compose_graphs.ladders.values()
        s_rec, sc_rec = lg.launches
        assert _kinds(s_rec) == plan
        assert _kinds(sc_rec) == {k: 2 * n for k, n in plan.items()}
