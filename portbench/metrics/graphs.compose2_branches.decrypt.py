"""Fork sites of compose2 in the decrypt's ladder at 512 lanes: the mean
`branches` (the CG's compose2 fork sites, `CG.branches`) of the
program's `graphs.ladder` spans at that batch inside the requests. Nothing
where no such span carries the attribute (a program whose compose2 is one
sequence of kernels)."""

import statistics

from portbench import spans

LAYER = "Graphs"
MOVES = "decrypt_p90_s"


def read(ctx):
    recs = spans.records()
    if recs is None or not ctx.requests:
        return None
    branches = [r.attrs["branches"] for r in spans.in_requests(recs, ctx, "graphs.ladder")
                if r.attrs.get("lanes") == 512 and "branches" in r.attrs]
    return statistics.fmean(branches) if branches else None
