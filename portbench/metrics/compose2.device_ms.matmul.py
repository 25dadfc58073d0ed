"""Device ms of one compose2 at 16384 lanes (the matmul's ladder): the
kernel time of the graph launches inside the replays at that batch."""

LAYER = "compose2"
MOVES = "matmul_ops_per_s"


def read(ctx):
    return ctx.trace.graph_ms("compose2@16384") if ctx.trace else None
