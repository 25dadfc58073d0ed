"""The k=256 cell's readers and its roofline on synthetic contexts: the
part-decryption share takes the CoFHE nodes' `engine.part_decrypt` spans
of the configuration's discriminant only; the k=256 compose2 work sums the
same kernel instances as roofline.py's and equals it at k=128 under k=128's
trips; compose2's device time is that of its graph replays, without the
ladder's step graphs; the wide roofline prices the wide instances' runs in
the device trace at compose2's sites and the window's lanes; the cell
reports the accepted network readers; and every reader returns nothing
where the run (or a program without the wide instances) has nothing to
read."""

from types import SimpleNamespace

import pytest

from portbench import harness, roofline, roofline_k256, spans

from toy import ROOT

CELL = "threshold_k256"
W256 = {"L": 160, "Lh": 80, "Lxn": 96, "Lu": 224, "Lm": 296, "Lsq": 152, "W8": 8,
        "Ldelta": 320}


def ctx(**kw):
    c = harness.Context(setup_s=1.0, units=512, widths=W256, roofline=roofline,
                        config={"disc_bits": 2341})
    c.__dict__.update(kw)
    return c


def read(name, c, recs=None):
    reader = harness.load_reader(ROOT, f"{name}.{CELL}")
    saved = spans.records
    spans.records = lambda: recs
    try:
        return reader.read(c)
    finally:
        spans.records = saved


def rec(name, a_ms, b_ms, request_id=0, **attrs):
    return SimpleNamespace(name=name, start_ns=round(a_ms * 1e6), end_ns=round(b_ms * 1e6),
                           request_id=request_id, span_id=0, parent_id=None, thread=1,
                           attrs=attrs)


def test_part_decrypt_share_takes_the_cofhe_nodes_spans_at_2341_bits():
    recs = [rec("node.request", 0, 1000, request_id=7, role="cofhe"),
            rec("node.request", 0, 1000, request_id=8, role="cofhe"),
            rec("node.request", 0, 1000, request_id=9, role="compute"),
            rec("engine.part_decrypt", 100, 500, request_id=7, disc_bits=2341, lanes=512),
            rec("engine.part_decrypt", 300, 700, request_id=8, disc_bits=2341, lanes=512),
            rec("engine.part_decrypt", 0, 1000, request_id=9, disc_bits=2341, lanes=512),
            rec("engine.part_decrypt", 800, 900, request_id=7, disc_bits=2085, lanes=512)]
    c = ctx(requests=[(0.0, 1.0)])
    assert read("engine.part_decrypt_share_pct", c, recs) == pytest.approx(60.0)
    # the parent's span has no disc_bits: nothing to read
    old = [rec("node.request", 0, 1000, request_id=7, role="cofhe"),
           rec("engine.part_decrypt", 100, 500, request_id=7)]
    assert read("engine.part_decrypt_share_pct", c, old) is None
    assert read("engine.part_decrypt_share_pct", c, None) is None


def test_k256_roofline_is_roofline_py_at_k128_under_its_trips(monkeypatch):
    w = roofline.WIDTHS_SEC128_K128
    monkeypatch.setattr(roofline_k256, "TRIPS", roofline.TRIPS["decrypt"])
    for B in (128, 512, 16384):
        assert roofline_k256.compose2_bounds(B, w) == roofline.compose2_bounds(B, w, "decrypt")


def test_k256_roofline_counts_every_kernel_at_its_widths():
    got = roofline_k256.compose2_bounds(512, W256)
    assert len(got) == len(roofline.compose2_bounds(512, roofline.WIDTHS_SEC128_K128,
                                                    "decrypt"))
    assert got["K5m sq"] == roofline.k5m(512, 152, 152, 296)
    assert got["K6a csum"] == roofline.k6a(512, 296, [(512, 296, False), (1, 320, False)])
    assert 0 < roofline_k256.compose2_bound_ms(512, W256) == sum(got.values())
    assert roofline_k256.TRIPS["k2"] > 0 and roofline_k256.TRIPS["k3"] > 0


def test_wide_sites_are_compose2s_rows_past_288():
    got = roofline_k256.compose2_bounds(512, W256)
    assert roofline_k256.wide_sites(512, W256) == {
        "mod_topdown": [got["K2"]], "mag_mul": [got["K5m t1"], got["K5m sq"]],
        "canon_sm": [got["K6a csum"]], "c3_operands": [got["K6e"]]}


def kernel(name, corr, ns=100_000):
    return (0, ns, f"void (anonymous namespace)::{name}(P)", corr)


class FakeTrace:
    busy_s, window_s = 3.0, 4.0
    # (start ns, end ns, kernel name, correlation): the wide instances'
    # runs of one compose2, narrow instances, then a compose2 graph replay
    # (correlation 7: K6b and two more kernels), the ladder's S step (8: one
    # compose2 and the state's copy), its SC step (9: two compose2s and the
    # plan's gather) and an eager K6b launch (10, not a graph)
    dev = [(0, 2000, "void (anonymous namespace)::mod_topdown_kernel<10, 6>(int const*)", 1),
           (0, 1000, "void (anonymous namespace)::mag_mul_kernel<10, 4>(int const*)", 1),
           (0, 1000, "void (anonymous namespace)::mag_mul_kernel<10, 4>(int const*)", 1),
           (0, 500, "_ZN12_GLOBAL__N_115canon_sm_kernelILi10ELi1EEEvNS_6ParamsE", 1),
           (0, 500, "void (anonymous namespace)::c3_operands_kernel<10>(Params)", 1),
           (0, 9000, "void (anonymous namespace)::mod_topdown_kernel<9, 5>(int const*)", 1),
           (0, 9000, "void (anonymous namespace)::mag_mul_kernel<9, 4>(int const*)", 1),
           kernel("compose_prologue_kernel<5>", 7), kernel("xgcd_coeff_g_kernel<3, false>", 7),
           kernel("reduce2_grouped_kernel<5>", 7, 200_000),
           kernel("compose_prologue_kernel<5>", 8), kernel("xgcd_coeff_g_kernel<3, false>", 8),
           kernel("reduce2_grouped_kernel<5>", 8, 200_000),
           (0, 3000, "Memcpy DtoD (Device -> Device)", 8),
           kernel("compose_prologue_kernel<5>", 9), kernel("compose_prologue_kernel<5>", 9),
           kernel("reduce2_grouped_kernel<5>", 9, 700_000), kernel("index_select", 9, 5000),
           kernel("compose_prologue_kernel<5>", 10, 50_000)]
    COMPOSE2_MS = 0.4  # the replay's alone

    def graph_ms(self, label):
        return None  # no harness range on the nodes' threads


def part_decrypts(*lanes):
    """Two CoFHE nodes' and the compute node's requests, the CoFHE nodes'
    part-decryptions at `lanes`."""
    recs = [rec("node.request", 0, 1000, request_id=7, role="cofhe"),
            rec("node.request", 0, 1000, request_id=8, role="cofhe"),
            rec("node.request", 0, 1000, request_id=9, role="compute")]
    return recs + [rec("engine.part_decrypt", 100, 500, request_id=7 + i % 2,
                       disc_bits=2341, lanes=n) for i, n in enumerate(lanes)]


def test_device_readers():
    c = ctx(requests=[(0.0, 1.0)], window_s=1.0, trace=FakeTrace())
    idle = harness.load_reader(ROOT, "device.idle_pct.threshold")
    assert idle.read(c) == pytest.approx(25.0)
    assert read("compose2.device_ms", c) == pytest.approx(FakeTrace.COMPOSE2_MS)
    assert read("compose2_roofline", c) == pytest.approx(
        100 * roofline_k256.compose2_bound_ms(512, W256) / FakeTrace.COMPOSE2_MS)


def test_wide_roofline_prices_the_windows_runs_at_its_lanes():
    c = ctx(requests=[(0.0, 1.0)], window_s=1.0, trace=FakeTrace())
    want = sum(sum(v) for v in roofline_k256.wide_sites(512, W256).values())
    assert read("kernels.wide_roofline", c, part_decrypts(512, 512)) == pytest.approx(
        100 * want / 0.005)
    # 1024 lanes: the same runs priced at that batch
    want = sum(sum(v) for v in roofline_k256.wide_sites(1024, W256).values())
    assert read("kernels.wide_roofline", c, part_decrypts(1024, 1024)) == pytest.approx(
        100 * want / 0.005)
    # part-decryptions at two lane counts, or none in the window: nothing
    assert read("kernels.wide_roofline", c, part_decrypts(512, 1024)) is None
    assert read("kernels.wide_roofline", c, part_decrypts()) is None
    assert read("kernels.wide_roofline", c, None) is None


def test_wide_roofline_reads_nothing_where_runs_are_not_compose2s():
    class Odd(FakeTrace):
        dev = [r for r in FakeTrace.dev if "c3_operands" not in r[2]]

    class Narrow(FakeTrace):
        dev = [r for r in FakeTrace.dev if "<10" not in r[2] and "ILi10E" not in r[2]]

    for trace in (Odd(), Narrow()):
        c = ctx(requests=[(0.0, 1.0)], window_s=1.0, trace=trace)
        assert read("kernels.wide_roofline", c, part_decrypts(512, 512)) is None


def test_compose2_time_leaves_out_the_ladders_step_graphs():
    class StepsOnly(FakeTrace):
        dev = [r for r in FakeTrace.dev if r[3] != 8]

    class NoReplay(FakeTrace):
        dev = [r for r in FakeTrace.dev if r[3] not in (7, 8)]

    c = ctx(requests=[(0.0, 1.0)], window_s=1.0, trace=StepsOnly())
    assert read("compose2.device_ms", c) == pytest.approx(0.4)
    c = ctx(requests=[(0.0, 1.0)], window_s=1.0, trace=NoReplay())
    assert read("compose2.device_ms", c) is None  # SC holds two compose2s


def test_the_cell_reports_the_accepted_network_readers():
    bench = harness.load_json(ROOT, "BENCHMARK.json")
    got = harness.cell_metrics(bench, "threshold_k256.decrypt_8x64", "per_layer")
    assert {"node.serialize_share_pct", "device.idle_pct.threshold",
            "graphs.replay_host_ms.threshold",
            "device.idle_in_part_decrypt_pct.threshold"} <= set(got)
    assert "smpc.part_decrypt_share_pct" not in got  # the program's span in its place
    assert harness.cell_metrics(bench, "threshold_k256.decrypt_8x64", "end_to_end") == [
        "setup_s", "threshold_decrypt_cts_per_s"]


@pytest.mark.parametrize("name", harness.cell_metrics(
    harness.load_json(ROOT, "BENCHMARK.json"), "threshold_k256.decrypt_8x64", "per_layer"))
def test_readers_return_nothing_without_a_trace(name):
    reader = harness.load_reader(ROOT, name)
    saved = spans.records
    spans.records = lambda: []
    try:
        assert reader.read(ctx(requests=[(0.0, 1.0)], window_s=1.0, spans={})) is None
    finally:
        spans.records = saved
