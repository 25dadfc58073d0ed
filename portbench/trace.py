"""Spans and the device trace of a traced run.

`Spans` wraps program functions from the benchmark's side: each call
records (start, end) on the host clock under a label, and opens a
`torch.profiler.record_function` range "portbench.<label>" so the device
trace can be cut by it.

`DeviceTrace` reads the profiler's events after the traced window: the
union of device activity on any card (busy seconds) and each card's own,
device time by kernel name, the longest idle gaps of each card labelled
by the innermost benchmark range open on the host at the time, and the
device time of the graph launches made inside each
"portbench.compose2@<lanes>" range.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import time
from typing import NamedTuple

from .spans import merged

PREFIX = "portbench."


class Spans:
    def __init__(self, torch):
        self.torch = torch
        self.intervals: dict = {}
        self._undo: list = []

    def add(self, label: str, t0: float, t1: float) -> None:
        self.intervals.setdefault(label, []).append((t0, t1))

    @contextlib.contextmanager
    def span(self, label: str):
        with self.torch.profiler.record_function(PREFIX + label):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.add(label, t0, time.perf_counter())

    def wrap(self, obj, attr: str, label: str) -> None:
        """Replace obj.attr by a wrapper recording a span a call (undone by
        `restore`)."""
        orig = getattr(obj, attr)
        had = attr in vars(obj) if hasattr(obj, "__dict__") else True

        @functools.wraps(orig)
        def wrapper(*a, **kw):
            with self.span(label):
                return orig(*a, **kw)

        setattr(obj, attr, wrapper)
        self._undo.append((obj, attr, orig, had))

    def restore(self) -> None:
        for obj, attr, orig, had in reversed(self._undo):
            if had:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self._undo.clear()


def union_within(intervals, lo: float, hi: float) -> float:
    """Length of the union of `intervals` clipped to [lo, hi]."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def share_pct(intervals, requests) -> float | None:
    """100 x the time inside `intervals` (their union) over the time of
    `requests`, each request's part clipped to it; None without spans."""
    if not intervals or not requests:
        return None
    inside = sum(union_within(intervals, a, b) for a, b in requests)
    return 100.0 * inside / sum(b - a for a, b in requests)


class Event(NamedTuple):
    """One profiler event as `DeviceTrace` reads it: an operation on card
    `card` (its CUDA index), or, with `card` None, an event on host thread
    `thread` (a benchmark range, a graph launch). `correlation` ties a
    graph launch to the operations it ran."""

    name: str
    start_ns: int
    end_ns: int
    card: int | None = None
    thread: int = 0
    correlation: int = 0


class DeviceTrace:
    """The device side of one traced run, from its events; `window_s` is
    the host time the run covered, `cards` the CUDA indices the cell uses
    (a card with no operation reads idle throughout)."""

    def __init__(self, events, window_s: float, cards=()):
        self.window_s = window_s
        dev, on_card, ranges, launches = [], {}, {}, []
        for e in events:
            if e.card is not None:
                if not e.name.startswith(PREFIX) and e.end_ns > e.start_ns:
                    dev.append((e.start_ns, e.end_ns, e.name, e.correlation))
                    on_card.setdefault(e.card, []).append((e.start_ns, e.end_ns))
            elif e.name.startswith(PREFIX):
                ranges.setdefault(e.thread, []).append(
                    (e.start_ns, e.end_ns, e.name[len(PREFIX):]))
            elif e.name == "cudaGraphLaunch":
                launches.append((e.start_ns, e.thread, e.correlation))
        dev.sort()
        self.dev = dev
        self.ranges = {t: sorted(r) for t, r in ranges.items()}
        self._starts = {t: [x[0] for x in r] for t, r in self.ranges.items()}
        self.busy = merged((a, b) for a, b, _, _ in dev)
        self.busy_s = sum(b - a for a, b in self.busy) / 1e9
        self.cards = sorted(set(cards) | set(on_card))
        self.busy_on = {c: merged(on_card.get(c, ())) for c in self.cards}
        self.busy_by_card = {c: sum(b - a for a, b in m) / 1e9
                             for c, m in self.busy_on.items()}
        self.graph_ns = self._graph_time(launches)

    @classmethod
    def from_profiler(cls, prof, window_s: float, cards=()):
        """The trace of a finished `torch.profiler.profile` run."""
        from torch.autograd import DeviceType

        events = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                events.append(Event(e.name(), e.start_ns(), e.end_ns(), card=e.device_index(),
                                    correlation=e.correlation_id() or e.linked_correlation_id()))
            else:
                events.append(Event(e.name(), e.start_ns(), e.end_ns(),
                                    thread=e.start_thread_id(), correlation=e.correlation_id()))
        return cls(events, window_s, cards)

    def idle_pct(self, card: int) -> float:
        """Share of the window in which card `card` ran nothing."""
        return 100.0 * (1.0 - self.busy_by_card.get(card, 0.0) / self.window_s)

    def _innermost(self, thread, t: int) -> str | None:
        """The range of `thread` open at t that started last (ranges nest)."""
        rs = self.ranges.get(thread, ())
        i = bisect.bisect_right(self._starts[thread], t) - 1 if rs else -1
        while i >= 0:
            a, b, label = rs[i]
            if b >= t:
                return label
            i -= 1
        return None

    def _graph_time(self, launches) -> dict:
        """{range label: [device ns of each graph launch made inside it]}."""
        by_corr: dict = {}
        for a, b, _, corr in self.dev:
            if corr:
                by_corr[corr] = by_corr.get(corr, 0) + (b - a)
        out: dict = {}
        for ts, thread, corr in launches:
            label = self._innermost(thread, ts)
            if label is not None and corr in by_corr:
                out.setdefault(label, []).append(by_corr[corr])
        return out

    def graph_ms(self, label: str) -> float | None:
        """Mean device ms of the graph launches inside `label` ranges."""
        xs = self.graph_ns.get(label)
        return sum(xs) / len(xs) / 1e6 if xs else None

    def device_ops(self, top: int = 10) -> list:
        tot: dict = {}
        for a, b, name, _ in self.dev:
            key = name if len(name) <= 96 else name[:93] + "..."
            tot[key] = tot.get(key, 0) + (b - a)
        return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps between device activity on a card, each named by
        the innermost benchmark range open on any host thread at its middle,
        and by the card where the trace has more than one."""
        gaps = [(b2 - a1, a1, b2, c) for c, busy in self.busy_on.items()
                for (_, a1), (b2, _) in zip(busy, busy[1:])]
        out = []
        for length, a, b, card in sorted(gaps, reverse=True)[:top]:
            mid = (a + b) // 2
            labels = [self._innermost(t, mid) for t in self.ranges]
            labels = [x for x in labels if x]
            label = " | ".join(sorted(set(labels))) or "no benchmark range"
            if len(self.cards) > 1:
                label = f"cuda:{card}: {label}"
            out.append([label, length / 1e9])
        return out
