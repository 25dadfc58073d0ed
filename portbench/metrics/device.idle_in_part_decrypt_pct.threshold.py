"""Share of the device's idle time within the requests that lies inside
the CoFHE nodes' part-decryptions (the union of their `engine.part_decrypt`
spans): how much of the card's waiting is on the nodes' ladders' host work,
and how much on the wire, (de)serialization and the combine. The spans are
mapped into the profiler's clock by the median offset of the requests
(portbench/spans.py); None where the offsets spread over 100 us."""

from portbench import spans

LAYER = "Device"
MOVES = "threshold_decrypt_cts_per_s"


def read(ctx):
    recs = spans.records()
    if recs is None or ctx.trace is None:
        return None
    offset = spans.profiler_offset_ns(ctx)
    if offset is None:
        return None
    cofhe = spans.request_ids(recs, "cofhe")
    parts = spans.merged((r.start_ns + offset, r.end_ns + offset) for r in recs
                         if r.name == "engine.part_decrypt" and r.request_id in cofhe)
    if not parts:
        return None
    idle = [g for a, b in spans.request_ranges(ctx.trace)
            for g in spans.gaps_within(ctx.trace.busy, a, b)]
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    return 100.0 * spans.overlap(idle, parts) / total
