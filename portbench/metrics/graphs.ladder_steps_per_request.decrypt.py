"""wNAF ladder steps a request at 512 lanes (the decrypt's ladder): the
`steps` (its digits, one step graph launch each) of the program's
`graphs.ladder` spans at that batch inside the requests, summed, over the
number of requests. Nothing where the program runs its ladder as compose2
replays (no such span)."""

from portbench import spans

LAYER = "Graphs"
MOVES = "decrypt_p90_s"


def read(ctx):
    recs = spans.records()
    if recs is None or not ctx.requests:
        return None
    steps = [r.attrs["steps"] for r in spans.in_requests(recs, ctx, "graphs.ladder")
             if r.attrs.get("lanes") == 512]
    return sum(steps) / len(ctx.requests) if steps else None
