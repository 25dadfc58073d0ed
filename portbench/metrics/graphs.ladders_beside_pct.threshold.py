"""Share of the window's requests in which the CoFHE nodes' ladders ran on
streams of their own beside each other: a request counts where at least one
of the program's `graphs.ladder` spans at 512 lanes inside it, of a CoFHE
node's `node.request`, has `beside` >= 1 (another stream's ladder was still
queued or running on the card when it started). A span without `beside`
reads 0: a program whose ladders share one stream. Nothing where no
request holds such a span."""

from portbench import spans

LAYER = "Graphs"
MOVES = "threshold_decrypt_cts_per_s"


def read(ctx):
    recs = spans.records()
    if recs is None or not ctx.requests:
        return None
    cofhe = spans.request_ids(recs, "cofhe")
    ladders = [r for r in spans.in_requests(recs, ctx, "graphs.ladder")
               if r.attrs.get("lanes") == 512 and r.request_id in cofhe]
    held, beside = 0, 0
    for a, b in ctx.requests:
        inside = [r for r in ladders if a * 1e9 <= r.start_ns and r.end_ns <= b * 1e9]
        if inside:
            held += 1
            beside += any(r.attrs.get("beside", 0) >= 1 for r in inside)
    return 100.0 * beside / held if held else None
