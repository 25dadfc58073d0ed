"""Share of request time inside the program's `engine.recode` spans (the
matmul's signed-window recoding of the plaintext matrix on the host): their
union within the requests, over request time, on the one host clock."""

from portbench import spans
from portbench.trace import share_pct

LAYER = "Engine"
MOVES = "matmul_ops_per_s"


def read(ctx):
    recs = spans.records()
    if recs is None:
        return None
    found = spans.in_requests(recs, ctx, "engine.recode")
    if not found:
        return None
    return share_pct([(r.start_ns / 1e9, r.end_ns / 1e9) for r in found], ctx.requests)
