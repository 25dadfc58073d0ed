"""The program's own spans (`cofhe_tpu_torch.utils.trace`) as the per-layer
metrics read them after a traced run.

The program records spans while a torch profiler runs, so the traced window
turns them on; each record has `name`, `thread`, `start_ns` and `end_ns`
(on `time.perf_counter_ns()`, the clock of `ctx.requests`), `span_id`,
`parent_id`, `request_id` and `attrs`. A program without the tracer gives
no records, and its readers return None.

The profiler's events run on another clock. `profiler_offset_ns` maps the
host clock into it: the benchmark's own request span is both a profiler
range ("portbench.request", in `ctx.trace.ranges`) and a host-clock
interval (`ctx.spans["request"]`), so each request gives one offset (the
midpoints'); their median maps, and offsets that spread over `limit_ns`
map nothing.
"""

from __future__ import annotations

import statistics

OFFSET_SPREAD_NS = 100_000


def records():
    """The program's span records, or None where it has no tracer."""
    try:
        from cofhe_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.records()


def in_requests(recs, ctx, name: str) -> list:
    """The records `name` that lie inside one of the window's requests."""
    reqs = [(a * 1e9, b * 1e9) for a, b in ctx.requests or ()]
    return [r for r in recs if r.name == name
            and any(a <= r.start_ns and r.end_ns <= b for a, b in reqs)]


def request_ids(recs, role: str) -> set:
    """Request ids of the `node.request` spans of the nodes of `role`: every
    span a node records while serving a request carries its id."""
    return {r.request_id for r in recs
            if r.name == "node.request" and r.attrs.get("role") == role}


def mean_ms(spans) -> float | None:
    if not spans:
        return None
    return statistics.fmean(r.end_ns - r.start_ns for r in spans) / 1e6


def request_ranges(trace) -> list:
    """(start, end) ns of the benchmark's request ranges in the profiler's
    clock, in order."""
    return sorted((a, b) for rs in trace.ranges.values() for a, b, label in rs
                  if label == "request")


def clock_offsets_ns(ctx) -> list | None:
    """Per request, the profiler clock minus the host clock, in ns, from the
    midpoints of its profiler range and its host-clock span."""
    if ctx.trace is None:
        return None
    ranges = request_ranges(ctx.trace)
    hosts = sorted(ctx.spans.get("request", ()))
    if not ranges or len(ranges) != len(hosts):
        return None
    return [(a + b) / 2 - (t0 + t1) / 2 * 1e9 for (a, b), (t0, t1) in zip(ranges, hosts)]


def profiler_offset_ns(ctx, limit_ns: float = OFFSET_SPREAD_NS) -> float | None:
    """The median offset, or None without offsets or where they spread
    (max - min) over `limit_ns`."""
    offs = clock_offsets_ns(ctx)
    if not offs or max(offs) - min(offs) > limit_ns:
        return None
    return statistics.median(offs)


def merged(intervals) -> list:
    """The union of `intervals` as sorted disjoint [a, b] pairs."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def gaps_within(busy, lo: float, hi: float) -> list:
    """The parts of [lo, hi] outside the sorted disjoint `busy` pairs."""
    out, at = [], lo
    for a, b in busy:
        if b <= at:
            continue
        if a >= hi:
            break
        if a > at:
            out.append([at, a])
        at = max(at, b)
    if at < hi:
        out.append([at, hi])
    return out


def overlap(xs, ys) -> float:
    """Length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total
