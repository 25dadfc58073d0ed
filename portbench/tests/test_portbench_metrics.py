"""The metric arithmetic: rates count every completed request over the
whole window, the p90 is taken over every request, shares take the union
of spans clipped to the requests, and the readers return nothing where
the run has nothing to read."""

import statistics

import pytest

from portbench import harness
from portbench.trace import share_pct, union_within

from toy import ROOT


def ctx(**kw):
    c = harness.Context(setup_s=7.5, units=512, widths={}, roofline=None)
    c.__dict__.update(kw)
    return c


def read(name, c):
    return harness.load_reader(ROOT, name).read(c)


def test_rate_is_all_work_over_the_whole_window():
    c = ctx(requests=[(0.0, 1.0), (1.0, 2.5), (2.5, 3.0)], window_s=4.0)
    assert read("threshold_decrypt_cts_per_s", c) == 3 * 512 / 4.0
    assert read("matmul_ops_per_s", c) == 3 * 512 / 4.0
    assert read("setup_s", c) == 7.5


def test_p90_over_every_request():
    lat = [0.80 + 0.01 * i for i in range(20)]
    c = ctx(requests=[(10.0 * i, 10.0 * i + x) for i, x in enumerate(lat)], window_s=200.0)
    want = statistics.quantiles(lat, n=10, method="inclusive")[-1]
    assert read("decrypt_p90_s", c) == pytest.approx(want)
    assert min(lat) <= want <= max(lat)
    assert harness.p90([0.5]) == 0.5


@pytest.mark.parametrize("spans,reqs,want", [
    ([(0.0, 1.0)], [(0.0, 2.0)], 50.0),
    ([(0.0, 1.0), (0.5, 1.5)], [(0.0, 2.0)], 75.0),        # overlapping: the union
    ([(-1.0, 0.5), (1.9, 3.0)], [(0.0, 2.0)], 30.0),       # clipped to the request
    ([(0.2, 0.4), (5.2, 5.6)], [(0.0, 1.0), (5.0, 6.0)], 30.0),
])
def test_share_is_union_clipped_to_requests(spans, reqs, want):
    assert share_pct(spans, reqs) == pytest.approx(want)


def test_union_within_nested():
    assert union_within([(0, 10), (2, 3), (4, 12)], 1, 11) == pytest.approx(10)


def test_engine_phase_shares():
    phases = {"chain_s": 0.2, "ladder_s": 0.5, "finalize_s": 0.1}
    c = ctx(requests=[(0.0, 1.0), (1.0, 2.0)], window_s=2.0,
            counters=[{"replays": 10, "matmul_phases": phases}] * 2)
    assert read("engine.ladder_share_pct.matmul", c) == pytest.approx(50.0)
    assert read("engine.host_share_pct.matmul", c) == pytest.approx(20.0)
    assert read("graphs.replays_per_request.decrypt", c) == 10


class FakeTrace:
    busy_s, window_s = 3.0, 4.0

    def graph_ms(self, label):
        return {"compose2@16384": 4.9, "compose2@512": 0.55}.get(label)


def test_device_readers():
    from portbench import roofline

    w = roofline.WIDTHS_SEC128_K128
    c = ctx(requests=[(0.0, 1.0)], window_s=1.0, trace=FakeTrace(), widths=w,
            roofline=roofline)
    assert read("device.idle_pct.decrypt", c) == pytest.approx(25.0)
    assert read("compose2.device_ms.matmul", c) == 4.9
    assert read("compose2_roofline.matmul", c) == pytest.approx(
        100 * roofline.compose2_bound_ms(16384, w, "ladder") / 4.9)
    assert 0 < read("compose2_roofline.decrypt", c) < 100


@pytest.mark.parametrize("name", ["smpc.part_decrypt_share_pct", "node.serialize_share_pct",
                                  "engine.host_share_pct.matmul",
                                  "engine.ladder_share_pct.matmul",
                                  "engine.part_decrypt_share_pct.decrypt",
                                  "compose2.device_ms.decrypt", "compose2_roofline.decrypt",
                                  "device.idle_pct.threshold",
                                  "graphs.replays_per_request.decrypt"])
def test_readers_return_nothing_without_data(name):
    assert read(name, ctx(requests=[(0.0, 1.0)], window_s=1.0)) is None
