"""The device trace from plain events, as the profiler's would give them:
on one card the busy union, the device time by kernel, the idle gaps and
the graph launches' device time read as the harness has always read
them; on several cards each card's busy time and idle share, and the
idle gaps name the card that idled."""

import pytest

from portbench.trace import DeviceTrace, Event

WINDOW_S = 1e-6


def host(name, a, b, thread=1, correlation=0):
    return Event(name, a, b, thread=thread, correlation=correlation)


def kernel(name, a, b, card=0, correlation=0):
    return Event(name, a, b, card=card, correlation=correlation)


ONE_CARD = [
    host("portbench.request", 0, 1000),
    host("portbench.compose2@512", 100, 300),
    host("cudaGraphLaunch", 150, 160, correlation=7),
    kernel("portbench.request", 0, 1000),       # the range's annotation on the card
    kernel("K1", 200, 400, correlation=7),
    kernel("K2", 350, 500, correlation=7),
    kernel("K3", 700, 900),
    kernel("K0", 950, 950),                      # no duration
]


def test_one_card_reads_as_before():
    t = DeviceTrace(ONE_CARD, WINDOW_S)
    assert t.busy == [[200, 500], [700, 900]]
    assert t.busy_s == pytest.approx(500e-9)
    ops = t.device_ops()
    assert [o[0] for o in ops] == ["K1", "K3", "K2"]
    assert [o[1] for o in ops] == pytest.approx([200e-9, 200e-9, 150e-9])
    assert t.idle_gaps() == [["request", pytest.approx(200e-9)]]
    assert t.graph_ms("compose2@512") == pytest.approx(350e-6)
    assert [d[2] for d in t.dev] == ["K1", "K2", "K3"]
    assert t.cards == [0] and t.busy_by_card == {0: t.busy_s}
    assert t.idle_pct(0) == pytest.approx(50.0)


def test_the_cells_cards_the_trace_names_alike():
    one = DeviceTrace(ONE_CARD, WINDOW_S)
    named = DeviceTrace(ONE_CARD, WINDOW_S, cards=[0])
    assert named.idle_gaps() == one.idle_gaps() and named.busy_by_card == one.busy_by_card


TWO_CARDS = [
    host("portbench.request", 0, 1000),
    host("portbench.part_decrypt", 400, 700, thread=2),
    kernel("K", 0, 100, card=0),
    kernel("K", 300, 400, card=0),
    kernel("K", 50, 250, card=1),
    kernel("L", 600, 700, card=1),
]


def test_each_card_busy_and_the_card_that_idled():
    t = DeviceTrace(TWO_CARDS, WINDOW_S, cards=[0, 1, 2])
    assert t.busy_s == pytest.approx(450e-9)              # any card busy
    assert t.busy_by_card == pytest.approx({0: 200e-9, 1: 300e-9, 2: 0.0})
    assert [t.idle_pct(c) for c in (0, 1, 2)] == pytest.approx([80.0, 70.0, 100.0])
    ops = t.device_ops()                                  # summed over cards
    assert [o[0] for o in ops] == ["K", "L"]
    assert [o[1] for o in ops] == pytest.approx([400e-9, 100e-9])
    gaps = t.idle_gaps()
    assert [g[0] for g in gaps] == ["cuda:1: part_decrypt | request", "cuda:0: request"]
    assert [g[1] for g in gaps] == pytest.approx([350e-9, 200e-9])
