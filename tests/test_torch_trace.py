"""The port's span tracer (cofhe_tpu_torch/utils/trace.py) and its sites.

Off, a span site returns one shared no-op and records nothing; on (inside
`enabled()` or while a torch profiler runs, in every thread) spans nest,
carry their parent's id and their root's request id, stay children across
a thread pool that runs them in a copy of the caller's context, and fill a
bounded buffer. One client decrypt through an in-process node network gives
each node's request span, the CoFHE nodes' with their part-decryption as a
child on the executor's thread. Untraced, the matmul never synchronizes the
card for its phase clocks; traced, it fills `last_matmul_phases` with the
keys it always had. Graph replays only count themselves, the launch
counters add each graph's keys when read, and a freed graph's launches stay
counted."""

import contextvars
import copy
import gc
import os
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from cofhe_tpu_torch.ops import cuda_group, engine as engine_mod
from cofhe_tpu_torch.utils import trace
from cofhe_tpu_torch.utils.benchmark import PhaseTimer


@pytest.fixture(autouse=True)
def fresh_records():
    trace.clear()
    yield
    trace.clear()


def _names(recs):
    return [r.name for r in recs]


def test_off_is_one_shared_noop_that_records_nothing():
    assert not trace.on()
    attrs = {"lanes": 4}
    for sp in (trace.span("a"), trace.span("b", attrs)):
        assert sp is trace.OFF and not sp
        with sp as inner:
            assert inner is trace.OFF
    assert trace._CURRENT.get() is None
    assert trace.records() == [] and trace.dropped() == 0


def test_nesting_parents_and_request_ids():
    with trace.enabled():
        assert trace.on()
        with trace.span("root", {"k": 1}) as root:
            assert trace._CURRENT.get() is root
            with trace.span("child") as child:
                with trace.span("grandchild") as grand:
                    pass
            with trace.span("sibling") as sib:
                pass
        with trace.span("second root") as other:
            pass
    assert not trace.on() and trace._CURRENT.get() is None
    assert root.parent_id is None and other.parent_id is None
    assert child.parent_id == root.span_id and sib.parent_id == root.span_id
    assert grand.parent_id == child.span_id
    assert {child.request_id, grand.request_id, sib.request_id} == {root.request_id}
    assert other.request_id != root.request_id
    assert len({root.span_id, child.span_id, grand.span_id, sib.span_id,
                other.span_id}) == 5
    # recorded as they end, each with its own interval inside its parent's
    assert _names(trace.records()) == ["grandchild", "child", "sibling", "root",
                                       "second root"]
    assert root.start_ns <= child.start_ns <= grand.start_ns <= grand.end_ns \
        <= child.end_ns <= sib.start_ns <= sib.end_ns <= root.end_ns
    assert root.attrs == {"k": 1} and child.attrs == {}
    assert root.thread == threading.get_ident()


def test_threads_record_their_own_spans_and_roots():
    got = {}
    together = threading.Barrier(3, timeout=30)  # alive at once: distinct idents

    def work(tag):
        with trace.span(tag) as sp:
            got[tag] = sp
        together.wait()

    with trace.enabled(), trace.span("main") as main:
        threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    spans = [got[f"t{i}"] for i in range(3)]
    # a thread started without the context is a root of its own request
    assert all(s.parent_id is None for s in spans)
    assert len({s.request_id for s in spans} | {main.request_id}) == 4
    assert len({s.thread for s in spans} | {main.thread}) == 4


def test_context_passed_through_a_thread_pool_keeps_the_parent():
    def rpc(i):
        with trace.span("rpc") as sp:
            return sp

    with trace.enabled(), ThreadPoolExecutor(max_workers=2) as pool:
        with trace.span("fanout") as fan:
            futures = [pool.submit(contextvars.copy_context().run, rpc, i) for i in range(4)]
            children = [f.result(timeout=30) for f in futures]
        bare = pool.submit(rpc, 9).result(timeout=30)
    assert all(c.parent_id == fan.span_id and c.request_id == fan.request_id
               for c in children)
    assert {c.thread for c in children} - {fan.thread}
    assert bare.parent_id is None and bare.request_id != fan.request_id


def test_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 3)
    with trace.enabled():
        for i in range(5):
            with trace.span(f"s{i}"):
                pass
    assert _names(trace.records()) == ["s0", "s1", "s2"] and trace.dropped() == 2
    trace.clear()
    assert trace.records() == [] and trace.dropped() == 0


def test_enabled_nests_and_every_thread_sees_it():
    seen = []
    with trace.enabled():
        with trace.enabled():
            pass
        t = threading.Thread(target=lambda: seen.append(trace.on()))
        t.start()
        t.join(timeout=30)
    assert seen == [True] and not trace.on()


def test_on_while_a_torch_profiler_runs_also_in_older_threads():
    go, done = threading.Event(), threading.Event()
    got = []

    def node():  # a thread started before the profiler, as a node's
        go.wait(timeout=30)
        with trace.span("node work") as sp:
            got.append(sp)
        done.set()

    t = threading.Thread(target=node)
    t.start()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.on()
        go.set()
        assert done.wait(timeout=30)
        with trace.span("main work"):
            pass
    t.join(timeout=30)
    assert not trace.on()
    assert got and got[0]
    assert sorted(_names(trace.records())) == ["main work", "node work"]
    with trace.span("after"):
        pass
    assert len(trace.records()) == 2


def test_phase_timer_is_a_view_over_the_tracer():
    timer = PhaseTimer("cpu")
    with timer("setup") as off:
        with trace.span("inside"):
            pass
    assert trace.records() == []  # timed, but not recorded with tracing off
    assert trace._CURRENT.get() is None
    with trace.enabled():
        with timer("setup") as on:
            with trace.span("inside") as inside:
                pass
    assert _names(trace.records()) == ["inside", "setup"]
    assert inside.parent_id == on.span_id
    assert timer.phases["setup"] == pytest.approx(off.seconds + on.seconds)


def test_traced_decorator_keeps_the_function():
    fn = engine_mod.TorchEngine.part_decrypt_batch
    assert fn.__name__ == "part_decrypt_batch"
    assert "wNAF ladder" in fn.__doc__

    @trace.traced("double")
    def double(x):
        return 2 * x

    assert double(4) == 8 and trace.records() == []
    with trace.enabled():
        assert double(5) == 10
    assert _names(trace.records()) == ["double"]


def test_traced_attrs_are_computed_only_while_tracing():
    calls = []

    def attrs(x):
        calls.append(x)
        return {"x": x}

    @trace.traced("triple", attrs)
    def triple(x):
        return 3 * x

    assert triple(2) == 6 and calls == [] and trace.records() == []
    with trace.enabled():
        assert triple(3) == 9
    (r,) = trace.records()
    assert r.name == "triple" and r.attrs == {"x": 3} and calls == [3]


def test_graph_replays_only_count_and_launches_add_them_when_read():
    key_a, key_b = ("mag_mul", 144, "72x72", 8), ("redc_mod", 72, 8, 8)
    before, before_a = dict(cuda_group.LAUNCHES), cuda_group.LAUNCHES_BY_KEY.get(key_a, 0)
    owner = Graph()
    g = cuda_group.graph_launches(owner, [key_a, key_b, key_a])
    assert g.per_replay == {key_a: 2, key_b: 1} and g.replays == 0
    assert dict(cuda_group.LAUNCHES) == before
    g.replays += 5
    assert cuda_group.LAUNCHES["mag_mul"] == before["mag_mul"] + 10
    assert cuda_group.LAUNCHES["redc_mod"] == before["redc_mod"] + 5
    assert cuda_group.LAUNCHES_BY_KEY[key_a] == before_a + 10
    cuda_group.count_launches([key_b])  # one eager launch
    assert cuda_group.LAUNCHES["redc_mod"] == before["redc_mod"] + 6
    cuda_group.reset_launches()
    assert set(cuda_group.LAUNCHES.values()) == {0} and len(cuda_group.LAUNCHES_BY_KEY) == 0
    g.replays += 1
    assert cuda_group.LAUNCHES_BY_KEY == {key_a: 2, key_b: 1}
    assert set(cuda_group.LAUNCHES) == set(cuda_group.KERNELS)


class Graph:
    """A launch record's owner, as a ComposeGraph is."""


def test_wide_launches_count_graph_replays_and_a_freed_graphs():
    wide, narrow = ("mag_mul", 296, "152x152", 512), ("mag_mul", 264, "136x136", 512)
    k6e = ("c3_operands", 296, 160, 512)
    cuda_group.reset_launches()
    assert dict(cuda_group.WIDE_LAUNCHES) == dict.fromkeys(cuda_group.WIDE_KERNELS, 0)
    owner = Graph()
    g = cuda_group.graph_launches(owner, [wide, narrow, wide, k6e])
    g.replays += 3
    assert cuda_group.WIDE_LAUNCHES["mag_mul"] == 6
    assert cuda_group.WIDE_LAUNCHES["c3_operands"] == 3
    assert cuda_group.LAUNCHES["mag_mul"] == 9  # the narrow ones count only there
    del owner
    gc.collect()
    assert cuda_group.WIDE_LAUNCHES["mag_mul"] == 6 and g not in cuda_group._GRAPHS
    cuda_group.count_launches([wide, ("mod_topdown", 296, 160, 512),
                               ("mod_topdown", 264, 144, 512)])
    assert dict(cuda_group.WIDE_LAUNCHES) == {"mod_topdown": 1, "mag_mul": 7,
                                              "canon_sm": 0, "c3_operands": 3}
    cuda_group.reset_launches()
    assert set(cuda_group.WIDE_LAUNCHES.values()) == {0}


def test_a_freed_graphs_launches_stay_counted():
    key = ("reduce2_grouped", 144, 0, 512)
    before = cuda_group.LAUNCHES_BY_KEY.get(key, 0)
    owner = Graph()
    g = cuda_group.graph_launches(owner, [key, key])
    g.replays += 3
    assert cuda_group.LAUNCHES_BY_KEY[key] == before + 6 and g in cuda_group._GRAPHS
    del owner
    gc.collect()
    assert cuda_group.LAUNCHES_BY_KEY[key] == before + 6
    assert g not in cuda_group._GRAPHS  # folded into the eager counts
    cuda_group.count_launches([key])
    assert cuda_group.LAUNCHES_BY_KEY[key] == before + 7


# ------------------------------------------------------------ the matmul


def test_part_decrypt_span_gives_disc_bits_and_lanes(toy_port_cs):
    cs, sk, pk = toy_port_cs
    from cofhe_tpu_torch.tensor import Tensor

    eng = cs._engine
    cts = cs.encrypt_tensor(pk, Tensor([1, 2, 3], (1, 3))).data
    with trace.enabled():
        eng.part_decrypt_batch(sk, cts)
        eng.part_decrypt_batch(0, cts)
    spans = [r for r in trace.records() if r.name == "engine.part_decrypt"]
    assert [r.attrs for r in spans] == [{"disc_bits": eng.cg.disc_bits, "lanes": 4},
                                        {"disc_bits": eng.cg.disc_bits, "lanes": 0}]


@pytest.fixture(scope="module")
def toy_port_cs():
    from conftest import toy_prime

    from cofhe_tpu_torch.api import CryptoSystem

    cs = CryptoSystem(128, 32, p=toy_prime(100), seed=b"trace-test", device="cpu")
    sk = cs.keygen()
    return cs, sk, cs.keygen(sk)


def test_untraced_matmul_never_synchronizes_and_traced_fills_its_phases(
        toy_port_cs, monkeypatch):
    from cofhe_tpu_torch.tensor import Tensor

    cs, sk, pk = toy_port_cs
    syncs = []
    monkeypatch.setattr(engine_mod.TorchEngine, "_synchronize",
                        lambda self: syncs.append(1))
    monkeypatch.setattr(engine_mod, "MATMUL_LANES", 4)  # one ct row a chunk
    ct = cs.encrypt_tensor(pk, Tensor([1, 2], (2, 1)))
    s = Tensor([2, 3], (1, 2))
    rand = copy.deepcopy(cs.rand_gen)  # both matmuls draw the same Enc(0)
    cs._engine.last_matmul_phases = {"chain_s": 1.0}  # a traced call's, earlier
    plain = cs.scal_ciphertext_tensors(pk, s, ct)
    assert syncs == [] and trace.records() == []
    assert not hasattr(cs._engine, "last_matmul_phases")
    cs.rand_gen = rand
    with trace.enabled(), trace.span("call") as call:
        traced = cs.scal_ciphertext_tensors(pk, s, ct)
    assert traced.data == plain.data  # tracing changes no result
    assert len(syncs) == 4  # chain and ladder of each of the two chunks
    phases = cs._engine.last_matmul_phases
    assert set(phases) == {"chain_s", "ladder_s", "finalize_s"}
    recs = trace.records()
    for key, name in (("chain_s", "engine.matmul.chain"), ("ladder_s", "engine.matmul.ladder"),
                      ("finalize_s", "engine.matmul.finalize")):
        spans = [r for r in recs if r.name == name]
        assert len(spans) == 2 and phases[key] == pytest.approx(sum(r.seconds for r in spans))
    assert [r for r in recs if r.parent_id is None] == [call]
    (recode,) = [r for r in recs if r.name == "engine.recode"]
    assert recode.parent_id == call.span_id
    assert all(r.request_id == call.request_id for r in recs)


# ----------------------------------------------- the node network's tree


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cpu_network():
    """Setup node, three CoFHE nodes, a compute node (t=2 of 3) and a client,
    in this process on loopback TCP, every engine on the CPU."""
    from conftest import toy_prime

    from cofhe_tpu_torch.core import cl_hsm2k
    from cofhe_tpu_torch.node import nodes
    from cofhe_tpu_torch.node.network_details import (CryptoSystemDetails, NodeDetails,
                                                      NodeType)

    old = os.environ.get("COFHE_P_OVERRIDE")
    os.environ["COFHE_P_OVERRIDE"] = hex(toy_prime(100))
    cl_hsm2k._cached_params.cache_clear()
    servers, client = [], None
    try:
        setup_nd = NodeDetails("127.0.0.1", str(_free_port()), NodeType.SETUP_NODE)
        details = CryptoSystemDetails(type="CoFHE_GPU", public_key="", security_level=128,
                                      k=32, threshold=2, total_nodes=3)
        server, setup = nodes.make_setup_node(setup_nd, details, device="cpu")
        server.run_in_thread()
        servers.append(server)
        for _ in range(3):
            nd = NodeDetails("127.0.0.1", str(_free_port()), NodeType.COFHE_NODE)
            servers.append(nodes.make_cofhe_node(nd, setup_nd, device="cpu"))
            servers[-1].run_in_thread()
        nd = NodeDetails("127.0.0.1", str(_free_port()), NodeType.COMPUTE_NODE)
        servers.append(nodes.make_compute_node(nd, setup_nd, device="cpu"))
        servers[-1].run_in_thread()
        client = nodes.ClientNode(setup_nd, use_tls=False, device="cpu")
        yield client, setup, servers[-1].handler.__self__
    finally:
        if client is not None:
            client.close()
        if len(servers) == 5:
            servers[-1].handler.__self__.smpc.close()
        for s in servers:
            s.stop()
        if old is None:
            os.environ.pop("COFHE_P_OVERRIDE", None)
        else:
            os.environ["COFHE_P_OVERRIDE"] = old
        cl_hsm2k._cached_params.cache_clear()


def test_one_client_decrypt_gives_each_nodes_request_tree(cpu_network):
    from cofhe_tpu_torch import serialize as ser
    from cofhe_tpu_torch.node import wire
    from cofhe_tpu_torch.tensor import Tensor

    client, setup, compute = cpu_network
    ct = client.crypto_system.encrypt_tensor(client.public_key, Tensor([5, 7], (1, 2)))
    operand = wire.ComputeOperand(wire.DataType.TENSOR, wire.DataEncryptionType.CIPHERTEXT,
                                  ser.serialize_ciphertext_tensor(ct))
    trace.clear()
    with trace.enabled():
        resp = client.compute(wire.ComputeRequest(wire.ComputeOperationType.UNARY,
                                                  wire.ComputeOperation.DECRYPT, [operand]))
    assert resp.status == wire.Status.OK
    assert ser.deserialize_plaintext_tensor(resp.data).data == [5, 7]
    # a server's span ends once its response is written, which may be after
    # its caller has read it
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        recs = trace.records()
        reqs = [r for r in recs if r.name == "node.request"]
        if sorted(r.attrs["role"] for r in reqs
                  if r.attrs["role"] != "setup") == ["cofhe", "cofhe", "compute"]:
            break
        time.sleep(0.01)
    (comp,) = [r for r in reqs if r.attrs["role"] == "compute"]
    cofhe = [r for r in reqs if r.attrs["role"] == "cofhe"]
    assert comp.attrs["service"] == "COMPUTE_REQUEST" and len(cofhe) == 2
    assert all(c.attrs["service"] == "COFHE_REQUEST" for c in cofhe)
    # the wire carries no id: each node's request is a root of its own
    assert all(r.parent_id is None for r in reqs)
    assert len({r.request_id for r in reqs}) == len(reqs)
    # the CoFHE nodes answer inside the compute node's request
    assert all(comp.start_ns <= c.start_ns <= c.end_ns <= comp.end_ns for c in cofhe)
    parts = [r for r in recs if r.name == "engine.part_decrypt"]
    assert len(parts) == 2
    for c in cofhe:
        # the handler ran on the executor's thread in the request's context
        (p,) = [r for r in parts if r.request_id == c.request_id]
        assert p.parent_id == c.span_id and p.thread != c.thread
        assert c.start_ns <= p.start_ns <= p.end_ns <= c.end_ns
    assert len({r.thread for r in [comp, *cofhe, *parts]}) >= 3
    assert all(r.start_ns <= r.end_ns for r in recs)
