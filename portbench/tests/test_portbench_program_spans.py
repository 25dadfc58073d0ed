"""The readers of the program's own spans on synthetic contexts: which
records they take (name, batch, the CoFHE nodes' requests, inside the
window's requests), the map from the host clock into the profiler's by the
requests' offsets and its refusal where they spread over 100 us, the idle
time inside the part-decryptions, and nothing where there is nothing to
read. Last, a toy traced matmul on the CPU reads its recoding share."""

import time
from types import SimpleNamespace

import pytest

from portbench import harness, spans

from toy import ROOT, make_tree, toy_prime, toy_prime_env


def ctx(**kw):
    c = harness.Context(setup_s=1.0, units=1, widths={}, roofline=None)
    c.__dict__.update(kw)
    return c


def read(name, c, recs):
    reader = harness.load_reader(ROOT, name)
    saved = spans.records
    spans.records = lambda: recs
    try:
        return reader.read(c)
    finally:
        spans.records = saved


_ids = iter(range(1, 10 ** 6))


def rec(name, a_ms, b_ms, request_id=0, parent_id=None, **attrs):
    """A span record at [a, b] ms on the host clock."""
    return SimpleNamespace(name=name, start_ns=round(a_ms * 1e6), end_ns=round(b_ms * 1e6),
                           request_id=request_id, span_id=next(_ids), parent_id=parent_id,
                           thread=1, attrs=attrs)


REQS = [(0.0, 1.0), (2.0, 3.0)]  # seconds


def test_replay_host_ms_takes_the_batch_inside_the_requests():
    recs = [rec("graphs.replay", 100, 100.2, lanes=512),
            rec("graphs.replay", 2500, 2500.4, lanes=512),
            rec("graphs.replay", 200, 205, lanes=16384),      # another batch
            rec("graphs.replay", 1500, 1501, lanes=512),      # between requests
            rec("engine.recode", 300, 301, lanes=512)]        # another span
    c = ctx(requests=REQS)
    assert read("graphs.replay_host_ms.decrypt", c, recs) == pytest.approx(0.3)


def test_threshold_replays_are_the_cofhe_nodes():
    recs = [rec("node.request", 10, 900, request_id=7, role="cofhe"),
            rec("node.request", 10, 900, request_id=8, role="cofhe"),
            rec("node.request", 5, 950, request_id=9, role="compute"),
            rec("graphs.replay", 100, 100.5, request_id=7, lanes=512),
            rec("graphs.replay", 100, 100.7, request_id=8, lanes=512),
            rec("graphs.replay", 920, 930, request_id=9, lanes=512)]  # the combine's
    c = ctx(requests=REQS)
    assert read("graphs.replay_host_ms.threshold", c, recs) == pytest.approx(0.6)
    assert read("graphs.replay_host_ms.decrypt", c, recs) == pytest.approx((0.5 + 0.7 + 10) / 3)


def test_recode_share_is_the_union_over_request_time():
    recs = [rec("engine.recode", 100, 300), rec("engine.recode", 200, 400),
            rec("engine.recode", 2000, 2100)]
    c = ctx(requests=REQS)
    assert read("engine.recode_share_pct.matmul", c, recs) == pytest.approx(
        100 * (0.3 + 0.1) / 2.0)


class FakeTrace:
    """Profiler clock = host clock + OFFSET ns; the device busy over
    `busy` (profiler ns)."""

    def __init__(self, busy, offsets=(0, 0)):
        self.ranges = {11: [(round(a * 1e9) + OFFSET + d, round(b * 1e9) + OFFSET + d, "request")
                            for (a, b), d in zip(REQS, offsets)]}
        self.busy = [list(x) for x in busy]


OFFSET = 5_000_000_000


def idle_ctx(offsets=(0, 0)):
    # device busy 0-0.6 s and 0.8-1.0 s of request 1, all of request 2 but 2.5-2.9 s
    busy = [(OFFSET + a * 10 ** 9 // 10, OFFSET + b * 10 ** 9 // 10)
            for a, b in ((0, 6), (8, 10), (20, 25), (29, 30))]
    return ctx(requests=REQS, spans={"request": REQS}, trace=FakeTrace(busy, offsets))


def threshold_recs():
    return [rec("node.request", 0, 1000, request_id=1, role="cofhe"),
            rec("node.request", 2000, 3000, request_id=2, role="cofhe"),
            rec("engine.part_decrypt", 500, 700, request_id=1),   # idle 0.6-0.7 inside
            rec("engine.part_decrypt", 2400, 2600, request_id=2),  # idle 2.5-2.6 inside
            rec("engine.part_decrypt", 650, 750, request_id=3)]   # not a CoFHE node's


def test_idle_in_part_decrypt_maps_the_spans_into_the_profiler_clock():
    # idle: 0.6-0.8 and 2.5-2.9 s = 0.6 s; inside the part-decryptions 0.1 + 0.1
    got = read("device.idle_in_part_decrypt_pct.threshold", idle_ctx(), threshold_recs())
    assert got == pytest.approx(100 * 0.2 / 0.6)
    # offsets spread by 90 us: still mapped (by their median)
    assert spans.profiler_offset_ns(idle_ctx((0, 90_000))) == pytest.approx(OFFSET + 45_000)
    got = read("device.idle_in_part_decrypt_pct.threshold", idle_ctx((0, 90_000)),
               threshold_recs())
    assert got == pytest.approx(100 * 0.2 / 0.6, rel=1e-3)


def test_idle_in_part_decrypt_refuses_offsets_that_spread_over_100_us():
    c = idle_ctx((0, 100_001))
    assert spans.clock_offsets_ns(c) == pytest.approx([OFFSET, OFFSET + 100_001])
    assert spans.profiler_offset_ns(c) is None
    assert read("device.idle_in_part_decrypt_pct.threshold", c, threshold_recs()) is None
    # and where requests and ranges do not pair up
    c = idle_ctx()
    c.spans = {"request": REQS[:1]}
    assert spans.profiler_offset_ns(c) is None


def test_interval_helpers():
    assert spans.merged([(5, 6), (0, 2), (1, 3), (4, 4)]) == [[0, 3], [5, 6]]
    assert spans.gaps_within([[0, 2], [3, 4], [9, 12]], 1, 10) == [[2, 3], [4, 9]]
    assert spans.gaps_within([], 1, 2) == [[1, 2]]
    assert spans.overlap([[0, 2], [3, 5]], [[1, 4]]) == 2


@pytest.mark.parametrize("name", ["graphs.replay_host_ms.decrypt",
                                  "graphs.replay_host_ms.threshold",
                                  "engine.recode_share_pct.matmul",
                                  "device.idle_in_part_decrypt_pct.threshold"])
def test_readers_return_nothing_without_spans(name):
    c = ctx(requests=REQS)
    assert read(name, c, []) is None
    assert read(name, c, None) is None  # a program without the tracer


def test_toy_traced_matmul_reads_its_recoding_share(tmp_path):
    from cofhe_tpu_torch.utils import trace

    root = make_tree(str(tmp_path))
    trace.clear()
    with toy_prime_env(toy_prime()):
        res, _ = harness.run_cell(root, "local.scal_matmul_2x4x4", 5000000011, 0.05, True,
                                  time.perf_counter())
    assert res["correct"]
    share = res["metrics"]["engine.recode_share_pct.matmul"]["value"]
    assert 0 < share < 100
    # the engine's phases, now from its spans, still read
    assert {"engine.ladder_share_pct.matmul", "engine.host_share_pct.matmul"} <= \
        set(res["metrics"])
