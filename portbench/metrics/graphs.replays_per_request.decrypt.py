"""compose2 graph replays a request (`ComposeGraph.replays`, summed over
the deployment's engines)."""

LAYER = "Graphs"
MOVES = "decrypt_p90_s"


def read(ctx):
    if not ctx.counters:
        return None
    return sum(c["replays"] for c in ctx.counters) / len(ctx.counters)
